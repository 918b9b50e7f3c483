"""Port parity for ``FlowNet2`` (FlowNetC, two FlowNetS refinements with
``resample2d`` warps, the FlowNetSD branch and FlowNetFusion) against
``jafpro_tpu.models.flownet.FlowNet2`` at 64², float32, and the bridge's
handling of its nested tree: the five sub-nets by path, FlowNetS's
bias-free ``up_flow*`` transposed convs and every ``batch_stats``.

Tolerance: 1e-4 relative to the largest output magnitude (as the other
nets); the bridge's round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jafpro_tpu.models import flownet as J

from jafpro_tpu_torch.bridge import flax_from_state_dict, load_flax
from jafpro_tpu_torch.checkpoints import flatten
from jafpro_tpu_torch.models import flownet as T

from _torch_flow_helpers import assert_rel, nchw, nhwc, numpy_variables

torch.set_num_threads(1)


def test_flownet2_matches_jax_and_bridges_its_tree():
    jm, tm = J.FlowNet2(), T.FlowNet2()
    x = np.random.RandomState(4).rand(2, 64, 64, 6).astype(np.float32)
    v = numpy_variables(jm, jnp.zeros(x.shape), seed=4)
    assert set(v["params"]) == {"flownetc", "flownets_1", "flownets_2",
                                "flownets_d", "flownetfusion"}
    assert "bias" not in v["params"]["flownets_1"]["up_flow6"]
    load_flax(tm, v)
    assert tm.flownets_2.up_flow3.bias is None
    assert tm.flownetc.up_flow3.bias is not None

    # the bridge's inverse gives the tree back exactly
    back = flatten(flax_from_state_dict(tm))
    want_tree = flatten(jax.tree_util.tree_map(np.asarray, v))
    assert set(back) == set(want_tree)
    for k, a in want_tree.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)

    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm.eval()(nchw(x)))
    assert got.shape == (2, 64, 64, 2)
    assert_rel(got, want, 1e-4, "flownet2")
