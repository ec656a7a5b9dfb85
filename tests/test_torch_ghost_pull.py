"""The one-pass ghost pull (``repro_torch.kernels.ghost_pull``) on the CPU.

``ghost_pull`` runs its plain version off CUDA; the kernel on the card is
held to that version bit for bit by ``chip_smoke.py`` (phase 20). Here the
op's CPU path is held, bit for bit, to the sync as the LocalUpdate composed
it before the op existed (``_composed``: a gather and mask per table, a
``torch.where`` each and a ``torch.cat``), over widths 1, 500 and 6,805,
``need`` all 0, all 1 and drawn, masked slots whose owner is -1, and an
``n_max`` that is not a multiple of 32. A CPU LocalUpdate of J 4 epochs at
tau 2 returns the same tables and stats with the op as with the
composition, and calls the op exactly on its fp32 pulls from the tables; the
gated sync epochs that set the op's launch gate on the card
(``chip_smoke.sync_epochs``) count one a call on every executor.
"""
import numpy as np
import pytest
import torch

import repro_torch.core.fedais as tfedais
from repro_torch.api import method_config
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from repro_torch.kernels.ghost_pull import ops
from repro_torch.models.gcn import HIDDEN, gcn_init
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)

K, G = 3, 41
N_MAXES = (29, 64, 70)


def _composed(feats_all, hist1_all, owner, row, mask, need, ghost_feat, hist1, n_max):
    """The LocalUpdate's tau-gated sync as three steps: gather and mask the
    owners' rows, select them where ``need`` > 0, rebuild the table."""
    o, r = torch.clamp(owner, min=0).long(), row.long()
    gf = feats_all[o, r] * mask[:, None]
    gh = hist1_all[o, r] * mask[:, None]
    pulled = need[:, None] > 0
    return (torch.where(pulled, gf, ghost_feat),
            torch.cat([hist1[:n_max], torch.where(pulled, gh, hist1[n_max:])]))


def _case(width: int, need_kind: str, n_max: int, seed: int = 0):
    """Sources, slots and tables for one client of K; a third of the slots
    masked with owner -1 and row 0, as the partition pads them."""
    gen = torch.Generator().manual_seed(seed)
    h1 = 7
    feats_all = torch.randn((K, n_max, width), generator=gen)
    hist1_all = torch.randn((K, n_max + G, h1), generator=gen)
    owner = torch.randint(0, K, (G,), generator=gen, dtype=torch.int32)
    row = torch.randint(0, n_max, (G,), generator=gen, dtype=torch.int32)
    masked = torch.rand((G,), generator=gen) < 1 / 3
    owner[masked], row[masked] = -1, 0
    mask = (~masked).to(torch.float32)
    need = {"none": torch.zeros(G), "all": torch.ones(G),
            "drawn": (torch.rand((G,), generator=gen) < 0.5).to(torch.float32)}[need_kind]
    need = need * mask       # as ghost_need gives it
    ghost_feat = torch.randn((G, width), generator=gen)
    hist1 = torch.randn((n_max + G, h1), generator=gen)
    return feats_all, hist1_all, owner, row, mask, need, ghost_feat, hist1, n_max


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("n_max", N_MAXES)
@pytest.mark.parametrize("need_kind", ["none", "all", "drawn"])
@pytest.mark.parametrize("width", [1, 500, 6805])
def test_cpu_path_is_the_composition(width, need_kind, n_max):
    args = _case(width, need_kind, n_max, seed=width + n_max)
    before = [a.clone() for a in args[:-1]]
    launches = ops.ghost_pull.launches
    got = ops.ghost_pull(*args)
    want = _composed(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(_bits(g), _bits(w))
    # out of place: the inputs are as they were, the outputs are new buffers
    for a, b in zip(args[:-1], before):
        assert np.array_equal(a.numpy(), b.numpy())
    for g in got:
        assert all(g.data_ptr() != a.data_ptr() for a in args[:-1])
    # the slots not pulled keep their rows, the masked ones among them
    keep = args[5] == 0
    assert np.array_equal(_bits(got[0][keep]), _bits(args[6][keep]))
    assert np.array_equal(_bits(got[1][:n_max]), _bits(args[7][:n_max]))
    assert ops.ghost_pull.launches == launches  # the CPU path launches nothing


def _bad(name):
    args = list(_case(5, "drawn", 29))
    i = {"feats": 0, "hist1_all": 1, "owner": 2, "row": 3, "mask": 4, "need": 5,
         "ghost_feat": 6, "hist1": 7}
    if name == "owner_int64":
        args[i["owner"]] = args[i["owner"]].long()
    elif name == "need_fp64":
        args[i["need"]] = args[i["need"]].double()
    elif name == "feats_bf16":
        args[i["feats"]] = args[i["feats"]].bfloat16()
    elif name == "ghost_feat_strided":
        args[i["ghost_feat"]] = torch.randn((5, G)).t()
    elif name == "hist1_rows":
        args[i["hist1"]] = args[i["hist1"]][1:]
    elif name == "mask_len":
        args[i["mask"]] = args[i["mask"]][1:]
    elif name == "feats_2d":
        args[i["feats"]] = args[i["feats"]][0]
    elif name == "width":
        args[i["ghost_feat"]] = torch.randn((G, 6))
    return args


@pytest.mark.parametrize("name,error", [
    ("owner_int64", TypeError), ("need_fp64", TypeError), ("feats_bf16", TypeError),
    ("ghost_feat_strided", ValueError), ("hist1_rows", ValueError), ("mask_len", ValueError),
    ("feats_2d", ValueError), ("width", ValueError)])
def test_kernel_checks_raise(name, error):
    """What the CUDA path checks before it launches: a wrong dtype, layout or
    shape raises (the checks read no device, so they run here)."""
    ops._check(*_case(5, "drawn", 29))
    with pytest.raises(error):
        ops._check(*_bad(name))


@pytest.fixture(scope="module")
def small():
    g = make_dataset("pubmed", scale=32, seed=0)
    fed = partition_graph(g, 8, alpha=0.5, seed=0)
    return fed


def _local_update_inputs(fed, k=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    t = lambda a: torch.from_numpy(np.array(a))
    keys = ("features", "labels", "node_mask", "train_mask", "nbr_idx", "nbr_mask",
            "ghost_owner", "ghost_row", "ghost_mask")
    client = {n: t(getattr(fed, n)[k]) for n in keys}
    n_tot = fed.n_max + fed.g_max
    params = gcn_init(gen, fed.n_features, fed.n_classes, device="cpu")
    hist1_all = torch.randn((fed.n_clients, n_tot, HIDDEN[0]), generator=gen)
    return dict(params=params, client=client, feats_all=t(fed.features),
                hist1_all=hist1_all, hist1=hist1_all[k].clone(),
                age=torch.zeros(n_tot, dtype=torch.int32),
                ghost_feat=torch.randn((fed.g_max, fed.n_features), generator=gen),
                prev_loss=torch.full((fed.n_max,), -1.0))


@pytest.mark.parametrize("sync_dtype", ["fp32", "bf16"])
def test_local_update_matches_the_composition(small, sync_dtype, monkeypatch):
    """J 4 epochs at tau 2 from epoch 0 pull twice (epochs 0 and 2). On the
    fp32 wire both pulls go through the op, and the outputs equal those of
    the composition put in its place, bit for bit; the bf16 wire keeps its
    own path and never calls the op."""
    fed = small
    mcfg = method_config("fedais", tau0=2)
    assert mcfg.local_epochs == 4
    inp = _local_update_inputs(fed)

    def run():
        one = tfedais.make_local_update(mcfg, fed.n_max, sync_dtype=sync_dtype)
        return one(inp["params"], inp["client"], inp["feats_all"], inp["hist1_all"],
                   inp["hist1"], inp["age"], inp["ghost_feat"], inp["prev_loss"], 2, 10, 0,
                   tfedais.TorchDraws(7, torch.device("cpu")))

    calls = []
    real = tfedais.ghost_pull
    with monkeypatch.context() as mp:
        mp.setattr(tfedais, "ghost_pull", lambda *a: calls.append(a) or real(*a))
        got = run()
    with monkeypatch.context() as mp:
        mp.setattr(tfedais, "ghost_pull", _composed)
        want = run()
    assert len(calls) == (2 if sync_dtype == "fp32" else 0)
    for a in calls:
        assert a[0] is inp["feats_all"] and a[1] is inp["hist1_all"] and a[8] == fed.n_max
    g_params, g_hist1, g_age, g_ghost, g_stats = got
    w_params, w_hist1, w_age, w_ghost, w_stats = want
    for name in g_params:
        assert np.array_equal(_bits(g_params[name].detach()), _bits(w_params[name].detach()))
    assert np.array_equal(_bits(g_hist1), _bits(w_hist1))
    assert np.array_equal(_bits(g_ghost), _bits(w_ghost))
    assert np.array_equal(g_age.numpy(), w_age.numpy())
    assert g_stats["n_sync"] == w_stats["n_sync"] == 2
    for key in ("loss_all", "epoch_losses", "n_ghost_pulled", "mean_importance_entropy"):
        assert np.array_equal(_bits(g_stats[key].reshape(-1)), _bits(w_stats[key].reshape(-1)))
    # the pull did act: some ghost rows changed from the ones given
    assert not torch.equal(g_ghost, inp["ghost_feat"])



FAULTS = dict(seed=78, dropout=0.2, corrupt=0.05, corrupt_mode="nan", straggler_frac=0.3)
RUNS = {"fused": {}, "stepwise": {"fused": False}, "fused_faulty": {"faults": FAULTS},
        "async_faults": {"faults": FAULTS, "async": True}, "int8": {"sync_dtype": "int8"}}


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_chip_smoke_sync_epochs_count_the_pulls(kind, monkeypatch):
    """``chip_smoke.sync_epochs``, which sets the ghost pull's launch gate
    on the card, counts one epoch a call of the op on every executor: the
    dropped clients' too (they train and pull, but bill no sync), none on
    the quantised wire (which never calls the op)."""
    import importlib.util
    from pathlib import Path

    from repro_torch import api
    from repro_torch.faults import FaultPlan

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    kw = dict(RUNS[kind])
    if "faults" in kw:
        kw["faults"] = FaultPlan(**kw["faults"])
    if kw.pop("async", False):
        kw["scheduler"] = api.AsyncScheduler(quorum=3, concurrency=5, timeout_s=1.0,
                                             max_retries=1)
    if kw.pop("fused", True) is False:
        kw["scheduler"] = api.SyncScheduler(fused=False)
    g = make_dataset("pubmed", scale=32, seed=0)
    fed = partition_graph(g, 8, alpha=0.5, seed=0)
    eng = api.FedEngine(g, fed, "fedais", rounds=3, clients_per_round=5, seed=0, device="cpu",
                        **kw)
    calls = []
    real = tfedais.ghost_pull
    monkeypatch.setattr(tfedais, "ghost_pull", lambda *a: calls.append(1) or real(*a))
    with cs.sync_epochs() as epochs:
        res = eng.run(eng.init_state())
    assert epochs[0] == len(calls)
    if kind == "int8":
        assert not calls and res.costs.sync_events > 0
    elif "faults" in RUNS[kind]:
        assert len(calls) > res.costs.sync_events > 0
    else:
        assert len(calls) == res.costs.sync_events > 0
