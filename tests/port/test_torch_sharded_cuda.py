"""Tensor parallelism across cards over NCCL (marked ``cuda``; skips below
two cards): Qwen3-1.7B at full width and depth in fp32, one rank per card
(``launch/mesh.run_on_mesh``'s default devices, so NCCL), on 1 x 2 and,
with four cards, on 1 x 4 and 2 x 2: ``forward``, ``prefill`` and four
``decode_step``s against the unsharded port on card 0 within the JAX
sharded script's bound of 5e-3 of the logits' scale, and every rank's
kernel 1 and kernel 4 launched. Run it on a machine with the cards:

    PYTHONPATH=src python -m pytest -q -m cuda \\
        tests/port/test_torch_sharded_cuda.py
"""

import pytest
import torch

import sharded_recipes as R
from repro_torch.launch import mesh as M

TOL = 5e-3


@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two CUDA cards or more ({n} visible)")
    from repro_torch.kernels import build
    build.library()                 # before the ranks, which load it
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(1, 2), (1, 4), (2, 2)])
def test_qwen3_over_nccl_matches_one_card(cards, sizes):
    if sizes[0] * sizes[1] > cards:
        pytest.skip(f"{sizes} needs {sizes[0] * sizes[1]} cards")
    shape = M.mesh_shape(sizes)
    assert M.backend_for(M.rank_devices(shape.size)) == "nccl"
    out = M.run_on_mesh(R.card_qwen, shape, timeout=900)
    for r in out:
        assert r["launches"]["flash"] > 0 and r["launches"]["decode"] > 0
    for what, (err, scale) in out[0]["errors"].items():
        assert err <= TOL * max(scale, 1.0), (sizes, what, err, scale)
