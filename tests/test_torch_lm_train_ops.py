"""The LM training path's pieces in the port against the reference, on CPU
tensors: ``softmax_xent`` (with and without a mask), the three lr
schedules (bit-equal in fp32), ``TokenPipeline`` batches (bit-equal),
AdamW over a nested tree with fp32 and bf16 moments, and
``wkv_chunked_scan``'s values and gradients. Also: on a device tensor
that needs a gradient the WKV6 kernel's wrapper goes through ``WKV6`` (the
kernels' autograd function) and its launch checks, and the RWKV block
picks its WKV as the reference does (``use_kernel`` over ``rwkv_chunk``),
so on a device the chunk never routes round the kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro.optim import adam as jadam
from repro.optim import schedules as jsched
import dataclasses

from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline, make_lm_batch
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models import layers as tlayers
from repro_torch.models import rwkv as trwkv
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50), dtype=np.float32) * 4
    labels = rng.integers(0, 50, size=(3, 7))
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    got = tlayers.softmax_xent(torch.tensor(logits), torch.tensor(labels),
                               None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_softmax_xent_empty_mask_divides_by_one():
    logits = torch.zeros((2, 3, 4))
    labels = torch.zeros((2, 3), dtype=torch.long)
    assert float(tlayers.softmax_xent(logits, labels, torch.zeros((2, 3)))) == 0.0


SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "cosine": lambda m: m.cosine_decay(1e-3, 50),
    "cosine_ratio": lambda m: m.cosine_decay(0.1, 7, 0.2),
    "warmup_cosine": lambda m: m.linear_warmup_cosine(3e-4, 21, 200),
    "warmup_cosine_no_warmup": lambda m: m.linear_warmup_cosine(3e-4, 0, 5),
    "warmup_cosine_train_driver": lambda m: m.linear_warmup_cosine(3e-4, 3, 24),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_bit_equal(name):
    from repro_torch import optim as topt

    ref, got = SCHEDULES[name](jsched), SCHEDULES[name](topt)
    steps = np.arange(0, 260)
    want = np.array([np.asarray(ref(jnp.int32(s)), np.float32) for s in steps])
    have = np.array([got(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(have.view(np.int32), want.view(np.int32))
    assert all(isinstance(got(int(s)), float) for s in steps[:3])


@pytest.mark.parametrize("seed,index", [(0, 0), (0, 5), (3, 17), (7, 2)])
def test_token_pipeline_bit_equal(seed, index):
    ref = jpipe.TokenPipeline(300, 24, 3, seed=seed)
    got = TokenPipeline(300, 24, 3, seed=seed)
    np.testing.assert_array_equal(got.batch(index)["tokens"], ref.batch(index)["tokens"])
    want = jpipe.make_lm_batch(ref, index)
    have = make_lm_batch(got, index, device="cpu")
    for key in ("tokens", "labels"):
        assert have[key].device.type == "cpu" and have[key].dtype == torch.int64
        np.testing.assert_array_equal(have[key].numpy(), np.asarray(want[key]))


def _tree(rng):
    """A nested tree like the LM's: dicts, a list of unit dicts."""
    a = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return {"embed": a(6, 4), "units": [{"w": a(4, 4), "ln": {"scale": a(4)}},
                                        {"w": a(4, 4), "ln": {"scale": a(4)}}],
            "head": a(4, 3)}


def _to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dtype) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32))


def _leaves_np(tree):
    return [t.float().numpy() for t in tree_leaves(tree)]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_tree_adamw_matches_reference(state_dtype):
    rng = np.random.default_rng(1)
    params, grads = _tree(rng), [_tree(rng) for _ in range(3)]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[state_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[state_dtype]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jadam.adamw_init(jp, jdt)
    tp = _to_torch(params)
    ts = adamw_init(tp, tdt)
    assert all(t.dtype == tdt for t in tree_leaves(ts.mu) + tree_leaves(ts.nu))
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, js = jadam.adamw_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr)
        tp, ts = adamw_update(_to_torch(g), ts, tp, lr)
    assert ts.step == int(js.step) == 3
    assert isinstance(tp["units"], list) and set(tp) == set(params)
    for got, want in zip(_leaves_np(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
    # moments: fp32 within rounding; bf16 within one bf16 ulp
    tol = 1e-6 if state_dtype == "float32" else 2.0 ** -8
    for got, want in zip(_leaves_np(ts.mu) + _leaves_np(ts.nu),
                         jax.tree_util.tree_leaves(js.mu) + jax.tree_util.tree_leaves(js.nu)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=1e-12)


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_adamw_in_slices_gives_the_same_bits(monkeypatch, state_dtype):
    """A leaf larger than ``UPDATE_CHUNK`` is updated a slice at a time;
    every element takes the same arithmetic, so params and moments equal
    the whole-leaf update's to the bit (bf16 params, fp32 or bf16
    moments, a transposed grad, a leaf of a size the slice does not
    divide)."""
    from repro_torch.optim import adam

    rng = np.random.default_rng(4)
    params = {"embed": torch.from_numpy(rng.standard_normal((37, 11), dtype=np.float32))
              .bfloat16(), "ln": torch.from_numpy(rng.standard_normal(5, dtype=np.float32))}
    grads = {"embed": torch.from_numpy(rng.standard_normal((11, 37), dtype=np.float32))
             .bfloat16().t(), "ln": torch.from_numpy(rng.standard_normal(5, dtype=np.float32))}
    state = adamw_init(params, state_dtype)
    whole = adamw_update(grads, state, params, 3e-2)
    monkeypatch.setattr(adam, "UPDATE_CHUNK", 64)
    sliced = adamw_update(grads, state, params, 3e-2)
    for a, b in zip(tree_leaves(whole[0]) + tree_leaves(whole[1].mu) + tree_leaves(whole[1].nu),
                    tree_leaves(sliced[0]) + tree_leaves(sliced[1].mu)
                    + tree_leaves(sliced[1].nu)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _wkv_inputs(seed, B, T, H, N):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N), dtype=np.float32) * 0.5 for _ in range(3))
    w = rng.uniform(0.6, 0.99, size=(B, T, H, N)).astype(np.float32)
    u = rng.standard_normal((H, N), dtype=np.float32) * 0.1
    s0 = rng.standard_normal((B, H, N, N), dtype=np.float32) * 0.1
    return r, k, v, w, u, s0


@pytest.mark.parametrize("T,chunk,with_state", [(32, 8, False), (32, 8, True), (30, 8, False),
                                                (24, 24, True)])
def test_wkv_chunked_scan_values_and_grads(T, chunk, with_state):
    r, k, v, w, u, s0 = _wkv_inputs(T + chunk, 2, T, 2, 4)
    args = [r, k, v, w, u] + ([s0] if with_state else [])

    def f(*a):
        return jrwkv.wkv_chunked_scan(*a[:5], chunk=chunk,
                                      state0=a[5] if with_state else None)

    (y_want, s_want), vjp = jax.vjp(f, *map(jnp.asarray, args))
    rng = np.random.default_rng(9)
    dy = rng.standard_normal(y_want.shape, dtype=np.float32)
    ds = rng.standard_normal(s_want.shape, dtype=np.float32)
    grads_want = vjp((jnp.asarray(dy), jnp.asarray(ds)))

    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y, s = trwkv.wkv_chunked_scan(*ts[:5], chunk=chunk, state0=ts[5] if with_state else None)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_want), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((y, s), ts, (torch.tensor(dy), torch.tensor(ds)))
    for got, want in zip(grads, grads_want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_wkv6_wrapper_refuses_a_gradient_off_the_cpu(monkeypatch):
    """A device tensor that needs a gradient (meta here: no card on the CPU)
    goes through ``WKV6`` and reaches the kernel's launch checks, which
    refuse a device that is not CUDA before any launch, with or without a
    gradient; the CPU's plain pair is differentiable."""
    r, k, v, w = (torch.empty((1, 4, 2, 32), device="meta", requires_grad=True)
                  for _ in range(4))
    u = torch.empty((2, 32), device="meta")
    reached = []
    real = wkv_ops.WKV6.forward

    def spy(ctx, *a):
        reached.append(a[0].device.type)
        return real(ctx, *a)

    monkeypatch.setattr(wkv_ops.WKV6, "forward", staticmethod(spy))
    launches = (wkv_ops.wkv6.launches, wkv_ops.wkv6_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_ops.wkv6(r, k, v, w, u)
    assert reached == ["meta"]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        wkv_ops.wkv6(r, k, v, w, u)
    assert reached == ["meta"]
    assert (wkv_ops.wkv6.launches, wkv_ops.wkv6_bwd.launches) == launches
    cpu = [torch.rand((1, 4, 2, 32), requires_grad=True) for _ in range(4)]
    y, s = wkv_ops.wkv6(*cpu, torch.rand((2, 32)))
    (y.sum() + s.sum()).backward()
    assert all(t.grad is not None for t in cpu)
    assert reached == ["meta", "cpu"]


def _rwkv_block(chunk):
    cfg = dataclasses.replace(get_smoke_config("rwkv6-1.6b"), rwkv_chunk=chunk)
    params = trwkv.rwkv_block_init(torch.Generator().manual_seed(0), cfg)
    return cfg, params


# (use_kernel, rwkv_chunk, gradient wanted) -> the WKV the block runs on CPU
# tensors: the reference's order (use_kernel first, then the chunk); the
# chunk only when a gradient is wanted; on the CPU the kernel's wrapper is
# the plain scan, so the chunk's checkpointing takes its place there
ROUTES = {(True, 8, True): "chunked", (True, 8, False): "wkv6", (True, 0, True): "wkv6",
          (False, 8, True): "chunked", (False, 8, False): "scan", (False, 0, True): "scan"}


@pytest.mark.parametrize("use_kernel,chunk,grad", sorted(ROUTES))
def test_rwkv_block_picks_its_wkv(monkeypatch, use_kernel, chunk, grad):
    cfg, params = _rwkv_block(chunk)
    routes = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            routes.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(trwkv.wkv_ops, "wkv6", spy("wkv6", wkv_ops.wkv6))
    monkeypatch.setattr(trwkv, "wkv_chunked_scan", spy("chunked", trwkv.wkv_chunked_scan))
    monkeypatch.setattr(trwkv, "wkv_scan", spy("scan", trwkv.wkv_scan))
    if grad:
        params = tree_map(lambda t: t.requires_grad_(True), params)
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out = trwkv.rwkv_block_apply(params, cfg, x, use_kernel=use_kernel)
    assert routes[0] == ROUTES[(use_kernel, chunk, grad)]
    assert out.requires_grad == grad and torch.isfinite(out).all()


@pytest.mark.parametrize("chunk", [0, 8])
def test_rwkv_block_with_the_kernel_refuses_a_gradient_off_the_cpu(monkeypatch, chunk):
    """On a device tensor (meta here) a block that runs the kernel and
    needs gradients goes through ``WKV6``, ``rwkv_chunk`` or not, and
    reaches the wrapper's launch checks (which refuse a device that is not
    CUDA), not a ``NotImplementedError``; without a gradient it reaches the
    same checks without ``WKV6``."""
    cfg, params = _rwkv_block(chunk)
    params = tree_map(lambda t: t.to("meta").requires_grad_(True), params)
    x = torch.empty((2, 16, cfg.d_model), device="meta")
    reached = []
    real = wkv_ops.WKV6.apply
    monkeypatch.setattr(wkv_ops.WKV6, "apply",
                        lambda *a: reached.append(len(a)) or real(*a))
    with pytest.raises(ValueError, match="CUDA"):
        trwkv.rwkv_block_apply(params, cfg, x)
    assert reached == [5]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        trwkv.rwkv_block_apply(params, cfg, x)
    assert reached == [5]
