"""The yardstick's counts: the FLOPs of one ``CRNSmaller`` at 256^2 are
the sum over its convolutions' and resizes' shapes; B1's bytes bound."""

import torch

from benchmark import counts
from benchmark.reference import nets

GEN = {"image_size": 256, "part_size": 200, "num_parts": 24,
       "face_crop_size": 64, "maximum_ref_frames": 4, "num_verts": 6890,
       "num_faces": 13776, "batch_size": 4}


def crn_by_shapes(crn, x, sp):
    """2 x multiply-adds of every convolution, from its input and output
    shapes, plus the two matrix products of each bilinear resize."""
    total = []

    def conv_hook(m, inp, out):
        cin_g = m.weight.shape[1]
        k = m.weight.shape[2] * m.weight.shape[3]
        total.append(2 * out.numel() * cin_g * k)

    hooks = [m.register_forward_hook(conv_hook) for m in crn.modules()
             if isinstance(m, torch.nn.Conv2d)]
    real = torch.matmul
    resizes = []

    def matmul(a, b):
        out = real(a, b)
        resizes.append(2 * out.numel() * a.shape[-1])
        return out

    torch.matmul = matmul
    try:
        crn(x, sp)
    finally:
        torch.matmul = real
        for h in hooks:
            h.remove()
    return sum(total) + sum(resizes), len(total)


def test_crn_flops_are_the_sum_over_its_shapes():
    crn = nets.build(modules=("refine",), device="meta").refine
    x = torch.empty(1, 3, 256, 256, device="meta")
    counted = counts.count_flops(lambda: crn(x, 256))
    by_shapes, n_convs = crn_by_shapes(crn, x, 256)
    assert n_convs == 2 * 6 + 2 * 7 + 2
    assert counted == by_shapes
    # the 512-wide decoder blocks dominate: ~0.29 TFLOP per 256^2 frame
    assert 2.5e11 < counted < 3.5e11


def test_generator_count_grows_with_references_and_frames():
    a = counts.generator_flops_per_clip(GEN, 1, 30)
    b = counts.generator_flops_per_clip(GEN, 4, 30)
    c = counts.generator_flops_per_clip(GEN, 4, 15)
    assert a < b and c < b
    assert 9e12 < b < 1.2e13


def test_b1_bytes_bound():
    assert counts.b1_bytes(GEN, 30) == 30 * (13776 * 36 + 65536 * 16)
    assert abs(counts.b1_bound_s(GEN, 30) * 1e3 - 0.01383) < 1e-5
