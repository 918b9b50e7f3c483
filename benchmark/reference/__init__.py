"""The plain reference of the benchmark: the JAFPro generator's forward
pass and its stage-4 training step in plain PyTorch, frozen here so that a
change to the program under test cannot move its yardstick.

It follows the published model (Larry-u/JAFPro; JAFPro, ACM MM 2020) as the
port lays it out: the same module tree and parameter names, so one seeded
set of weights loads into both. It computes in float32 (TF32 off) or, as the
correctness control, with every convolution and dense layer fed through a
scaled float8 (e4m3) cast (``precision.use``). It imports nothing of the
program: it rasterizes with a plain z-buffer, builds its own warp tables and
expands the uint8 wire format itself.
"""
