"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (the kernels have no CPU mode). The
file imports no JAX, so it runs on a GPU machine without the reference's
dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 relative (summation order), bf16 5e-4 relative (bf16
inputs, whose products are exact in f32; f32 accumulation in both, in
another order). The bf16 limit sits well above the largest reading on the
card and below what one 128-wide tile of G dropped or doubled would read.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (B, S, p_in, p_out): ragged S and p, S=1, three 64-row tiles, and one of
# llama3.2-1b's main-path shapes
SHAPES = [(2, 16, 24, 40), (3, 37, 80, 200), (1, 130, 70, 33),
          (2, 64, 128, 96), (2, 1, 8, 5), (1, 150, 40, 72),
          (2, 512, 2048, 512)]


def _pair(shape, seed):
    b, s, pi, po = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, pi)).astype(np.float32),
            rng.normal(size=(b, s, po)).astype(np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, shape, dtype):
    """f32: 1e-4 relative (summation order); bf16: 5e-4 relative."""
    dt = getattr(torch, dtype)
    rtol = 1e-4 if dtype == "float32" else 5e-4
    h, z = (torch.from_numpy(x).to(cuda_device, dt) for x in _pair(shape, 4))
    want = tref.gram_norm_ref(h, z)
    tops.reset_launch_counts()
    for got in (tops.gram_norm(h, z), tops.gram_norm(h, z, triangular=False),
                tops.direct_norm(h, z)):
        torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)
    assert tops.launch_counts() == {"gram_norm": 2, "direct_norm": 1}


@pytest.mark.cuda
def test_cuda_kernels_take_strided_inputs(cuda_device):
    """Batch/sequence strides go to the kernel as they are; a
    non-contiguous feature axis is copied by the wrapper."""
    h, z = (torch.from_numpy(x).to(cuda_device) for x in
            _pair((3, 40, 24, 36), 5))
    want = tref.gram_norm_ref(h, z)
    hs = torch.stack([h, h], dim=2).reshape(3, 80, 24)[:, ::2]  # S stride 2
    zt = z.transpose(1, 2).contiguous().transpose(1, 2)   # feature stride S
    torch.testing.assert_close(tops.gram_norm(hs, zt), want, rtol=1e-4,
                               atol=0.0)
    torch.testing.assert_close(tops.direct_norm(hs, zt), want, rtol=1e-4,
                               atol=0.0)


@pytest.mark.cuda
def test_cuda_bf16_unaligned_rows(cuda_device):
    """bf16 rows whose base is not 16-byte aligned and whose stride is odd
    take the element-by-element staging path of the tensor-core bodies."""
    h, z = (torch.from_numpy(x).to(cuda_device, torch.bfloat16) for x in
            _pair((3, 40, 25, 37), 6))
    h, z = h[:, :, 1:], z[:, :, 1:]
    want = tref.gram_norm_ref(h, z)
    torch.testing.assert_close(tops.gram_norm(h, z), want, rtol=5e-4,
                               atol=0.0)
    torch.testing.assert_close(tops.direct_norm(h, z), want, rtol=5e-4,
                               atol=0.0)


@pytest.mark.cuda
def test_cuda_engine_step_matches_cpu(cuda_device):
    """The smoke llama step on the card (kernels) against the same step on
    the CPU (plain versions), f32; the launches follow ``pick_method``."""
    from repro_torch import pex
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.core.norms import pick_method
    from repro_torch.models import registry
    from repro_torch.nn.param import tree_map

    spec = registry.get("llama3.2-1b")
    cfg = spec.smoke()
    params = registry.family_module(spec).init(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    shape = ShapeSpec("t", "train", 96, 3)
    batch = registry.make_train_batch(spec, cfg, shape, 0, device="cpu")
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    eng = pex.Engine(pex.PexSpec())
    want = eng.step(loss_fn, params, batch, [pex.Norms(), pex.Grads()])
    tops.reset_launch_counts()
    got = eng.step(loss_fn, tree_map(lambda x: x.to(cuda_device), params),
                   {k: v.to(cuda_device) for k, v in batch.items()},
                   [pex.Norms(), pex.Grads()])
    torch.testing.assert_close(got.sq_norms.cpu(), want.sq_norms, rtol=1e-4,
                               atol=0.0)
    a = cfg.attn
    d, hq, hkv, f = (cfg.d_model, a.n_heads_p * a.head_dim,
                     a.n_kv * a.head_dim, cfg.mlp.d_ff)
    picks = [pick_method(shape.seq, pi, po) for pi, po in
             ((d, hq), (d, hkv), (d, hkv), (hq, d), (d, f), (d, f), (f, d))]
    assert tops.launch_counts() == {
        "gram_norm": cfg.n_layers * picks.count("gram"),
        "direct_norm": cfg.n_layers * picks.count("direct") + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0, 8, 4, 3), (2, 0, 4, 3), (2, 8, 0, 3),
                                   (2, 8, 4, 0)])
def test_cuda_empty_inputs_launch_nothing(cuda_device, shape):
    """A zero extent has the norm 0; the wrappers answer it without a
    launch and leave the counters alone."""
    b, s, pi, po = shape
    h = torch.zeros(b, s, pi, device=cuda_device)
    z = torch.zeros(b, s, po, device=cuda_device)
    tops.reset_launch_counts()
    for got in (tops.gram_norm(h, z), tops.direct_norm(h, z)):
        assert got.shape == (b,) and got.device == h.device
        assert not bool(got.any())
    assert tops.launch_counts() == {"gram_norm": 0, "direct_norm": 0}
