"""Stage 1: texture accumulation alone, masked L1 (port of
``jafpro_tpu/train/stage1.py``; reference ``train/1.text_accu_LSTM.py``).

Adam 1e-4 with MultiStepLR [100k, 150k] x0.3; the loss sums over targets
the L1 over (union of reference masks) AND (target mask)
(``src/networks.py:1614-1639``), with the curriculum's reference mask
zeroing masked references.
"""

from __future__ import annotations

from jafpro_tpu_torch.losses import l1
from jafpro_tpu_torch.train.common import (
    TrainState, multistep_lr, normalize_batch)


def stage1_lrs():
    return {"accu": multistep_lr(1e-4)}


def make_stage1_step(pipe):
    """``step(state, batch) -> (state, {"loss"})``: one update of
    ``accu`` on a batch of (B, ...) tensors on ``pipe``'s device."""
    def loss_fn(batch):
        out_parts = pipe.accu(batch["src_parts"], batch["ref_mask"])
        masked = batch["src_mask_parts"] * \
            batch["ref_mask"][:, :, None, None, None]
        union = masked.amax(dim=1)  # (B, P, p, p)
        total = 0.0
        for t in range(batch["tgt_mask_parts"].shape[1]):
            area = (union * batch["tgt_mask_parts"][:, t])[..., None]
            total = total + l1(area * out_parts,
                               area * batch["tgt_parts"][:, t])
        return total

    def step(state: TrainState, batch):
        batch = normalize_batch(batch)
        loss = loss_fn(batch)
        state.apply_gradients(state.grads(loss, ("accu",)))
        return state, {"loss": loss.detach()}

    return step
