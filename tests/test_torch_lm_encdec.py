"""whisper-large-v3 (encoder, decoder, cross attention, learned positions)
and internvl2-2b (image tokens) on the port, against the reference, on CPU
tensors.

Per tier, inputs drawn with numpy from a seed go through both packages:

* the kernel's function with the query and key lengths apart:
  ``ops.flash_attention`` on CPU tensors (its plain version) against the
  reference's Pallas kernel in interpret mode, called directly on padded
  (BH, Sq, hd) and (BHkv, Sk, hd) arrays with ``seq_len = Sk``, the padded
  query rows sliced off; 2e-5, the reference's attention tolerance;
* the attention module: ``multihead_attn`` bidirectional and across
  (``kv_source``), ``decode_attn`` with ``cross_kv``; 2e-5;
* the slice: the smoke configs, the reference's own ``init_lm`` params
  loaded into the port, ``lm_forward``'s logits, ``lm_prefill``'s last
  logits and decode state (self K/V, cross K/V) and 4 decode steps at
  1e-4 (a few dozen dense products summed in another order);
* serving on the CPU: ``serve_lm_cli.serve`` and ``examples.serve_lm``.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.kernels.flash_attention.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.examples import serve_lm
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import serve_lm_cli
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

ATTN_TOL = 2e-5
TOL = 1e-4
ARCHS = ["whisper-large-v3", "internvl2-2b"]
BLOCK = 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the kernel's function, Sq != Sk
# ---------------------------------------------------------------------------

def _pallas(q, k, v, *, causal, window):
    """The reference's Pallas kernel (interpret mode) on (B, S, heads, hd)
    arrays: heads folded into the rows, Sq and Sk padded to the block,
    ``seq_len = Sk``, the padded query rows sliced off."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]

    def rows(x, S, heads):
        x = np.transpose(x, (0, 2, 1, 3)).reshape(B * heads, S, hd)
        pad = -S % BLOCK
        return jnp.asarray(np.pad(x, ((0, 0), (0, pad), (0, 0))))

    o = flash_attention_pallas(rows(q, Sq, H), rows(k, Sk, Hkv), rows(v, Sk, Hkv),
                               n_q_heads=H, seq_len=Sk, causal=causal, window=window,
                               block_q=BLOCK, block_k=BLOCK, interpret=True)
    o = np.asarray(o)[:, :Sq].reshape(B, H, Sq, hd)
    return np.transpose(o, (0, 2, 1, 3))


CROSS_CASES = [
    # b, sq, sk, h, hkv, hd, causal, window
    (2, 24, 77, 4, 4, 32, False, None),      # cross attention, ragged Sk
    (1, 40, 100, 4, 2, 64, False, None),     # GQA 2:1, Sk > Sq
    (2, 70, 33, 4, 1, 32, False, None),      # GQA 4:1, Sk < Sq
    (1, 1, 45, 2, 1, 16, False, None),       # one query row
    (1, 40, 100, 4, 2, 64, True, None),      # causal, Sq < Sk: key <= query from 0
    (2, 70, 33, 4, 1, 32, True, None),       # causal, Sq > Sk: the rows past Sk see all
    (1, 50, 97, 2, 2, 32, True, 16),         # causal with a window
]


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,causal,window", CROSS_CASES)
def test_flash_attention_sq_ne_sk_matches_pallas(b, sq, sk, h, hkv, hd, causal, window):
    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, hkv, hd)).astype(np.float32) for _ in range(2))
    got = flash_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert got.shape == (b, sq, h, hd)
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, causal=causal, window=window),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    assert flash_ops.flash_attention.launches == 0


def test_a_row_without_a_live_key_is_zero():
    """Causal with a window, Sq past Sk + window: the last rows keep no key
    and come out 0 (the kernels' acc / max(l, 1e-30)); the others are the
    softmax over their live keys."""
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((1, 30, 2, 16)).astype(np.float32))
    k, v = (_t(rng.standard_normal((1, 10, 2, 16)).astype(np.float32)) for _ in range(2))
    got = attention_ref(q, k, v, causal=True, window=4)
    assert (got[:, 13:] == 0).all() and (got[:, :13].abs().sum(-1) > 0).all()
    for i in (0, 5, 12):
        keys = slice(max(0, i - 3), min(i, 9) + 1)
        s = torch.einsum("hd,khd->hk", q[0, i], k[0, keys]) * 16 ** -0.5
        want = torch.einsum("hk,khd->hd", torch.softmax(s, -1), v[0, keys])
        np.testing.assert_allclose(got[0, i].numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    """On a device other than the CPU the shapes are checked first: k/v of
    another batch or head size, or no key at all, raise before a launch."""
    q = torch.empty((1, 8, 2, 32), device="meta")
    for k in (torch.empty((2, 9, 2, 32), device="meta"),
              torch.empty((1, 9, 2, 16), device="meta"),
              torch.empty((1, 0, 2, 32), device="meta")):
        with pytest.raises(ValueError):
            flash_ops._check_shapes(q, k, k)


# ---------------------------------------------------------------------------
# the attention module
# ---------------------------------------------------------------------------

def _attn_params(arch, seed):
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    jp = jattn.attn_init(jax.random.PRNGKey(seed), jc, cross=True)
    return jc, tc, jp, lm_params_from_numpy({"a": _np(jp)}, tc, "cpu")["a"]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_bidirectional_attention_matches_reference(use_kernel):
    """whisper's encoder attention (MHA at the smoke width, no RoPE),
    unmasked, with the K/V it returns."""
    jc, tc, jp, tp = _attn_params("whisper-large-v3", 1)
    x = np.random.default_rng(2).standard_normal((2, 21, jc.d_model)).astype(np.float32)
    out, (k, v) = tattn.multihead_attn(tp, tc, _t(x), kind="bidir", return_kv=True,
                                       use_kernel=use_kernel)
    jout, (jk, jv) = jattn.multihead_attn(jp, jc, jnp.asarray(x), kind="bidir",
                                          return_kv=True)
    for a, b in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches_reference(arch):
    """Q from the block's normed input (19 positions), K/V from an encoder
    output of 33 positions; internvl2's config has RoPE, which a cross call
    leaves out."""
    jc, tc, jp, tp = _attn_params(arch, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, jc.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 33, jc.d_model)).astype(np.float32)
    out, (k, v) = tattn.multihead_attn(tp, tc, _t(x), kind="bidir", kv_source=_t(src),
                                       return_kv=True)
    jout, (jk, jv) = jattn.multihead_attn(jp, jc, jnp.asarray(x), kind="bidir",
                                          kv_source=jnp.asarray(src), return_kv=True)
    assert k.shape == (2, 33, tc.n_kv_heads, tc.resolved_head_dim)
    for a, b in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_cross_decode_matches_reference_and_writes_nothing():
    jc, tc, jp, tp = _attn_params("whisper-large-v3", 5)
    rng = np.random.default_rng(6)
    hd = jc.resolved_head_dim
    xk, xv = (rng.standard_normal((2, 16, jc.n_kv_heads, hd)).astype(np.float32)
              for _ in range(2))
    cache = {n: rng.standard_normal((2, 12, jc.n_kv_heads, hd)).astype(np.float32)
             for n in ("k", "v")}
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    tcache = {n: _t(a) for n, a in cache.items()}
    out, back = tattn.decode_attn(tp, tc, _t(x), tcache, 7, cross_kv=(_t(xk), _t(xv)))
    jout, _ = jattn.decode_attn(jp, jc, jnp.asarray(x),
                                {n: jnp.asarray(a) for n, a in cache.items()},
                                jnp.asarray(7, jnp.int32),
                                cross_kv=(jnp.asarray(xk), jnp.asarray(xv)))
    assert back is tcache
    for n in ("k", "v"):
        np.testing.assert_array_equal(tcache[n].numpy(), cache[n])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATTN_TOL, rtol=ATTN_TOL)


# ---------------------------------------------------------------------------
# the slice: the smoke configs end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = jsmoke(arch), get_smoke_config(arch)
            jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jc)
            cache[arch] = (jc, tc, jp, lm_params_from_numpy(_np(jp), tc, "cpu"))
        return cache[arch]

    return get


def _extra_inputs(cfg, B, rng):
    """Random (not zero) image embeddings and encoder frames, so a
    misplaced position or a dropped input shows."""
    kw = {}
    if cfg.n_image_tokens:
        kw["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.n_encoder_layers:
        kw["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return kw


def _assert_trees_close(got, want, tol=TOL):
    want = _np(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch, models):
    jc, tc, jp, tp = models(arch)
    rng = np.random.default_rng(11)
    B, S, G = 2, 19, 4
    n_img = tc.n_image_tokens or 0
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    kw = _extra_inputs(tc, B, rng)
    tkw = {n: _t(a) for n, a in kw.items()}
    jkw = {n: jnp.asarray(a) for n, a in kw.items()}

    logits, _ = tlm.lm_forward(tp, tc, _t(toks).long(), **tkw)
    jlogits, _ = jax.jit(jlm.lm_forward, static_argnums=1)(jp, jc, jnp.asarray(toks), **jkw)
    assert logits.shape == (B, n_img + S, tc.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)

    max_len = n_img + S + G
    last, state = tlm.lm_prefill(tp, tc, _t(toks).long(), max_len, **tkw)
    jlast, jstate = jax.jit(jlm.lm_prefill, static_argnums=(1, 3))(
        jp, jc, jnp.asarray(toks), max_len, **jkw)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=TOL, rtol=TOL)
    assert ("cross" in state) == bool(tc.n_encoder_layers)
    _assert_trees_close(lm_params_to_numpy(state), jstate)

    j_decode = jax.jit(jlm.decode_step, static_argnums=1)
    for i in range(G):
        tok = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        pos = n_img + S + i
        out, state = tlm.decode_step(tp, tc, state, _t(tok).long(), pos)
        jout, jstate = j_decode(jp, jc, jstate, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=TOL)
    _assert_trees_close(lm_params_to_numpy(state), jstate)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_launch_count_and_inputs(arch, models, monkeypatch):
    """The prefill's flash calls on the CPU take the plain version (no
    launch); the same count on the card is ``chip_smoke.py``'s gate: one per
    ``enc`` and ``attn`` block, two per ``dec`` block. Without its encoder
    frames whisper refuses to run."""
    _, tc, _, tp = models(arch)
    calls = []
    real = flash_ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    kw = {n: _t(a) for n, a in _extra_inputs(tc, 1, np.random.default_rng(0)).items()}
    toks = torch.zeros((1, 9), dtype=torch.long)
    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    tlm.lm_prefill(tp, tc, toks, 20, **kw)
    monkeypatch.undo()
    if tc.n_encoder_layers:
        Se = tc.encoder_seq_len
        want = ([(Se, Se, False)] * tc.n_encoder_layers
                + [(9, 9, True), (9, Se, False)] * tc.n_layers)
        with pytest.raises(ValueError, match="enc_frames"):
            tlm.lm_prefill(tp, tc, toks, 20)
    else:
        S = tc.n_image_tokens + 9
        want = [(S, S, True)] * tc.n_layers
    assert calls == want
    assert flash_ops.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# serving on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_the_cpu(arch, capsys):
    got = serve_lm_cli.serve(argparse.Namespace(arch=arch, batch=2, prompt_len=7, gen=5,
                                                seed=0, device="cpu"))
    assert got["tokens"].shape == (2, 5)
    vocab = get_smoke_config(arch).vocab_size
    assert 0 <= int(got["tokens"].min()) and int(got["tokens"].max()) < vocab
    assert f"arch={arch}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_example_runs_on_the_cpu(arch, capsys):
    got = serve_lm.main(["--arch", arch, "--batch", "1", "--prompt-len", "6", "--gen", "3",
                         "--device", "cpu"])
    assert got["tokens"].shape == (1, 3)
    assert "prefill:" in capsys.readouterr().out
