"""Stage 2: accumulation + inpainting, target-visible L1 (port of
``jafpro_tpu/train/stage2.py``; reference
``train/2.text_inpaint_convLSTM.py``).

The loss sums over targets and parts the per-part L1 between
(inpainted * target mask) and (target * target mask); two Adams at 1e-4.
"""

from __future__ import annotations

from jafpro_tpu_torch.losses import l1
from jafpro_tpu_torch.train.common import TrainState, normalize_batch


def stage2_lrs():
    return {"accu": 1e-4, "inpaint": 1e-4}


def make_stage2_step(pipe, num_target: int = 2):
    """``num_target``: targets used per sample. The reference trains stage 2
    on 2 targets (``train/2.text_inpaint_convLSTM.py:62``) while textonly
    records hold stage 1's 3; the step slices, so one record layout serves
    both stages."""
    def loss_fn(batch):
        inpainted, _ = pipe.prepare_textures(
            batch["src_parts"], batch["ref_mask"], batch["src_mask_parts"])
        P = inpainted.shape[1]
        total = 0.0
        for t in range(min(num_target, batch["tgt_mask_parts"].shape[1])):
            m = batch["tgt_mask_parts"][:, t][..., None]
            # the reference sums 24 per-part L1 means; the parts are of
            # equal size, so that is num_parts * the atlas mean
            total = total + P * l1(inpainted * m,
                                   batch["tgt_parts"][:, t] * m)
        return total

    def step(state: TrainState, batch):
        batch = normalize_batch(batch)
        loss = loss_fn(batch)
        state.apply_gradients(state.grads(loss, ("accu", "inpaint")))
        return state, {"loss": loss.detach()}

    return step
