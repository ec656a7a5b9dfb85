"""Griffin (``rec``), the MoE FFN and the dense configurations on the port,
against the reference, on CPU tensors.

Configurations: every full config's sizes and shapes against the
reference's; per piece (the causal convolution, the RG-LRU gates, the
doubling scan against the reference's associative scan, the decode step,
both MoE dispatches and the aux loss) at 1e-5 on the same inputs; the
MoE's discrete decisions (top-k, rank, keep) exactly, an exact tie in the
router included; the convert round trip in bf16; whisper-large-v3 and
internvl2-2b accepted, with the reference's parameter tree. The smoke
configs end to end are in ``test_torch_lm_families_run.py`` and
``test_torch_lm_encdec.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.configs import input_specs as j_input_specs
from repro.configs import list_archs as jlist_archs
from repro.configs import shape_applicable as j_shape_applicable
from repro.configs.base import long_context_variant as j_long_context_variant
from repro.configs.shapes import concrete_inputs as j_concrete_inputs
from repro.models import griffin as jgriffin
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import (
    INPUT_SHAPES,
    get_config,
    get_smoke_config,
    input_specs,
    list_archs,
    long_context_variant,
    shape_applicable,
)
from repro_torch.configs.shapes import concrete_inputs
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import griffin as tgriffin
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

TOL = 1e-4
PIECE_TOL = 1e-5
ENC_IMG = ["whisper-large-v3", "internvl2-2b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=PIECE_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configurations and shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jlist_archs())
def test_configs_and_param_counts_equal_the_reference(arch):
    for got, want in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jsmoke(arch))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (dataclasses.asdict(long_context_variant(got))
                == dataclasses.asdict(j_long_context_variant(want)))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", jlist_archs())
def test_input_shapes_and_specs_equal_the_reference(arch):
    assert list_archs() == jlist_archs()
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in INPUT_SHAPES.items():
        ok, why = shape_applicable(cfg, shape)
        jok, jwhy = j_shape_applicable(jcfg, J_SHAPES[name])
        assert ok == jok and bool(why) == bool(jwhy)
        got, want = input_specs(cfg, shape), j_input_specs(jcfg, J_SHAPES[name])
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert _dtype_name(t.dtype) == str(want[k].dtype), (name, k)
    small = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=8, global_batch=2)
    scfg = get_smoke_config(arch)
    got = concrete_inputs(scfg, small, torch.Generator().manual_seed(0))
    want = j_concrete_inputs(jsmoke(arch), small)
    assert {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert int(got["tokens"].max()) < scfg.vocab_size


# ---------------------------------------------------------------------------
# Griffin, piece by piece
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rec_params():
    jc = jsmoke("recurrentgemma-2b")
    jp = jgriffin.rglru_block_init(jax.random.PRNGKey(3), jc)
    return jc, get_smoke_config("recurrentgemma-2b"), jp, jax.tree_util.tree_map(_t, _np(jp))


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    _close(tgriffin._causal_conv1d(_t(x), _t(w), _t(b)),
           jgriffin._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    # T shorter than the kernel
    _close(tgriffin._causal_conv1d(_t(x[:, :2]), _t(w), _t(b)),
           jgriffin._causal_conv1d(jnp.asarray(x[:, :2]), jnp.asarray(w), jnp.asarray(b)))


def test_rglru_gates_match_reference(rec_params):
    jc, tc, jp, tp = rec_params
    x = np.random.default_rng(1).standard_normal((2, 9, tc.rglru_width)).astype(np.float32)
    (a, b), (ja, jb) = tgriffin._rglru_gates(tp, tc, _t(x)), jgriffin._rglru_gates(jp, jc, x)
    _close(a, ja)
    _close(b, jb)
    # lam so large that 1 - a² rounds to 0: the clamp at 1e-12 holds
    big = dict(tp, lam=torch.full_like(tp["lam"], 40.0))
    jbig = dict(jp, lam=jnp.full_like(jp["lam"], 40.0))
    (a, b), (ja, jb) = tgriffin._rglru_gates(big, tc, _t(x)), jgriffin._rglru_gates(jbig, jc, x)
    _close(b, jb)


@pytest.mark.parametrize("T", [1, 3, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_associative_scan(T, with_h0):
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (2, T, 16)).astype(np.float32)
    b = rng.standard_normal((2, T, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32) if with_h0 else None
    h, last = tgriffin.rglru_scan(_t(a), _t(b), None if h0 is None else _t(h0))
    jh, jlast = jax.jit(jgriffin.rglru_scan)(jnp.asarray(a), jnp.asarray(b),
                                             None if h0 is None else jnp.asarray(h0))
    _close(h, jh)
    _close(last, jlast)


def test_rglru_block_decode_matches_reference(rec_params):
    jc, tc, jp, tp = rec_params
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
    st = {"h": rng.standard_normal((2, tc.rglru_width)).astype(np.float32),
          "conv": rng.standard_normal((2, tc.conv1d_width - 1,
                                       tc.rglru_width)).astype(np.float32)}
    out, new = tgriffin.rglru_block_decode(tp, tc, _t(x), {k: _t(v) for k, v in st.items()})
    jout, jnew = jax.jit(jgriffin.rglru_block_decode, static_argnums=1)(
        jp, jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    _close(out, jout)
    for k in ("h", "conv"):
        _close(new[k], jnew[k])


# ---------------------------------------------------------------------------
# MoE, piece by piece and its discrete decisions
# ---------------------------------------------------------------------------

def _moe(arch, **over):
    jc = dataclasses.replace(jsmoke(arch), **over)
    tc = dataclasses.replace(get_smoke_config(arch), **over)
    jp = jmoe.moe_init(jax.random.PRNGKey(5), jc)
    tp = jax.tree_util.tree_map(_t, _np(jp))
    return jc, tc, jp, tp


def _ref_decisions(jp, jc, x):
    """The reference's routing and sort dispatch (src/repro/models/moe.py:
    top-k, argsort, searchsorted), step by step."""
    T = x.shape[0]
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, jc.top_k)
    C = int(max(1, round(T * jc.top_k / jc.n_experts * jc.capacity_factor)))
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    seg_start = jnp.searchsorted(se, jnp.arange(jc.n_experts), side="left")
    rank = jnp.arange(flat_e.shape[0]) - seg_start[se]
    return C, np.asarray(top_i), np.asarray(order), np.asarray(rank), np.asarray(rank < C)


@pytest.mark.parametrize("arch,cf", [("dbrx-132b", 8.0), ("dbrx-132b", 1.0),
                                     ("arctic-480b", 0.5)])
@pytest.mark.parametrize("impl", ["sort", "einsum"])
def test_moe_apply_and_aux_match_reference(arch, cf, impl):
    jc, tc, jp, tp = _moe(arch, capacity_factor=cf, moe_impl=impl)
    x = np.random.default_rng(3).standard_normal((2, 11, tc.d_model)).astype(np.float32)
    out, aux = tmoe.moe_apply(tp, tc, _t(x))
    jout, jaux = jax.jit(jmoe.moe_apply, static_argnums=1)(jp, jc, jnp.asarray(x))
    _close(out, jout)
    _close(aux, jaux)


def test_moe_einsum_groups_match_reference():
    jc, tc, jp, tp = _moe("dbrx-132b", capacity_factor=1.0, moe_impl="einsum",
                          moe_group_size=4)
    x = np.random.default_rng(4).standard_normal((2, 12, tc.d_model)).astype(np.float32)
    out, aux = tmoe.moe_apply(tp, tc, _t(x))
    jout, jaux = jax.jit(jmoe.moe_apply, static_argnums=1)(jp, jc, jnp.asarray(x))
    _close(out, jout)
    _close(aux, jaux)


@pytest.mark.parametrize("tie", [False, True])
def test_moe_decisions_equal_the_reference(tie):
    """top_i, the stable order, the ranks and ``keep`` exactly equal; with
    ``tie`` experts 1 and 2 (and 0 and 3) have identical router columns, so
    every token has exact ties, which go to the lower index."""
    jc, tc, jp, tp = _moe("dbrx-132b", capacity_factor=1.0)
    if tie:
        r = np.array(jp["router"])
        r[:, 2], r[:, 3] = r[:, 1], r[:, 0]
        jp = dict(jp, router=jnp.asarray(r))
        tp = dict(tp, router=_t(r))
    x = np.random.default_rng(6).standard_normal((37, tc.d_model)).astype(np.float32)
    C, top_i, order, rank, keep = _ref_decisions(jp, jc, x)
    _, _, t_top_i, _ = tmoe.route(tp, tc, _t(x))
    t_order, t_rank, t_keep = tmoe.sort_dispatch(t_top_i, tmoe.capacity(37, tc), tc.n_experts)
    assert tmoe.capacity(37, tc) == C
    np.testing.assert_array_equal(t_top_i.numpy(), top_i)
    np.testing.assert_array_equal(t_order.numpy(), order)
    np.testing.assert_array_equal(t_rank.numpy(), rank)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    assert not keep.all() and keep.any()
    if tie:   # one of a tied pair is only ever picked as the lower index
        for lo, hi in ((0, 3), (1, 2)):
            assert ((top_i == hi).any(1) <= (top_i == lo).any(1)).all()
    out, aux = tmoe.moe_apply_sort(tp, tc, _t(x[None]))
    jout, jaux = jax.jit(jmoe.moe_apply_sort, static_argnums=1)(jp, jc,
                                                                jnp.asarray(x[None]))
    _close(out, jout)
    _close(aux, jaux)


def test_capacity_uses_pythons_round():
    """C = int(max(1, round(T·K/E·cf))): a 4-token decode step of dbrx-132b
    (cf 1.25) gets one slot per expert, its 8,192-token prefill 2,560."""
    cfg = get_config("dbrx-132b")
    assert tmoe.capacity(4, cfg) == 1
    assert tmoe.capacity(8192, cfg) == 2560
    assert tmoe.capacity(2, dataclasses.replace(cfg, top_k=5, n_experts=4,
                                                capacity_factor=1.0)) == round(2.5) == 2


@pytest.mark.parametrize("arch", ENC_IMG)
def test_whisper_and_internvl2_still_wait(arch):
    """They wait no more: ``check_supported`` accepts the full and the smoke
    configs, and the port's ``init_lm`` gives the reference's tree
    (``enc_units``, ``enc_norm``, ``enc_pos``, ``pos_emb``, a ``dec``
    block's ``xattn``), shapes and dtypes, in fp32 and in bf16."""
    for cfg in (get_smoke_config(arch), get_config(arch)):
        tlm.check_supported(cfg)
    for dt in ("float32", "bfloat16"):
        tc = dataclasses.replace(get_smoke_config(arch), dtype=dt)
        jc = dataclasses.replace(jsmoke(arch), dtype=dt)
        own = tlm.init_lm(torch.Generator().manual_seed(0), tc, "cpu")
        want = jax.eval_shape(lambda jc=jc: jlm.init_lm(jax.random.PRNGKey(0), jc))
        got = lm_params_to_numpy(own)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        paths = jax.tree_util.tree_flatten_with_path(want)[0]
        for (path, w), g in zip(paths, jax.tree_util.tree_leaves(got)):
            assert g.shape == w.shape, path
        for (path, w), t in zip(paths, jax.tree_util.tree_leaves(_stacked_dtypes(own))):
            assert t == _dtype_name(w.dtype), path
    assert ("enc_units" in own) == (arch == "whisper-large-v3")
    assert ("xattn" in own["units"][0]["b0"]) == (arch == "whisper-large-v3")


def _stacked_dtypes(params):
    """The port's tree with each leaf replaced by its dtype's name, the
    per-unit lists collapsed to one entry (the reference stacks them)."""
    out = {}
    for key, sub in params.items():
        if isinstance(sub, list):
            sub = sub[0]
        out[key] = jax.tree_util.tree_map(lambda t: _dtype_name(t.dtype), sub)
    return out


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "dbrx-132b", *ENC_IMG])
def test_convert_round_trip_is_bit_equal_in_bf16(arch):
    """The reference's bf16 params through the port and back, bit for bit;
    ``lam``, ``b_a``, ``b_i`` and ``router`` stay fp32 on both sides, the
    expert stacks are (E, d, ff); the port's own ``init_lm`` has the same
    layout and dtypes."""
    jc = dataclasses.replace(jsmoke(arch), dtype="bfloat16")
    tc = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    jp = _np(jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(1), jc))
    tp = lm_params_from_numpy(jp, tc, "cpu")
    back = lm_params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jp)
    fp32 = {"lam", "b_a", "b_i", "router"}
    paths = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path, want), got in zip(paths, jax.tree_util.tree_leaves(back)):
        name = path[-1].key
        np.testing.assert_array_equal(got, want.astype(np.float32))
        assert (want.dtype == np.float32) == (name in fp32), name
    unit = tp["units"][0]
    blocks = [unit[k] for k in unit]
    for bp in blocks:
        for name, t in _leaves_with_names(bp):
            assert t.dtype == (torch.float32 if name in fp32 else torch.bfloat16), name
    if tc.n_experts:
        assert tuple(blocks[0]["ffn"]["moe"]["w_in"].shape) == (tc.n_experts, tc.d_model,
                                                                tc.d_ff)
    own = lm_params_to_numpy(tlm.init_lm(torch.Generator().manual_seed(0), tc, "cpu"))
    shapes = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jc))
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(shapes)
    init = dict(_leaves_with_names(tlm.init_lm(torch.Generator().manual_seed(0), tc,
                                               "cpu")["units"][0]))
    assert all(init[n].dtype == torch.float32 for n in fp32 & set(init))
    for g, w in zip(jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(shapes)):
        assert g.shape == w.shape


def _leaves_with_names(tree, name=None):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves_with_names(v, k)]
    return [(name, tree)]
