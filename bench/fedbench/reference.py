"""The plain reference of a FedAIS training round, in PyTorch.

Written from the FedAIS paper (arXiv:2409.14655, Algorithm 1, Eq. 6-8 and
11) for the benchmark's comparison. It imports no module of the program and
takes no array the program made: the graph, the partition, the initial
weights and the seed come from the benchmark, and the reference keeps its
own params and tables.

A round, for each member k of the cohort in turn (each from the round-start
state):

* the loss pass: a 2-layer GraphSAGE forward over all of k's rows, layer 0
  over [own features | synced ghost features], layer 1 over k's historical
  layer-1 table (Eq. 6), and each node's cross-entropy;
* the selection probabilities (Eq. 8): |loss - previous loss| per training
  node (the loss itself where the node was never seen), plus a 1e-8 floor,
  normalised;
* J local epochs of AdamW (lr, wd 0.001 inside the lr product, fresh
  moments each round): a Gumbel top-k batch of ``batch`` nodes under those
  probabilities, a fanout subsample of each batch row's neighbours, a ghost
  pull every ``tau`` global epochs (the owners' features and round-start
  layer-1 rows of the ghosts the batch reaches), the batch forward and
  backward (the gradient reaches the params and, through layer 1, the fresh
  layer-1 rows of the batch), and the push of those rows into the table;

then the server's FedAvg (the members' params summed and divided by m) and
the write-back of each member's layer-1 table, ages, ghost features and
loss. The eval is the full-graph forward over the server's neighbour lists,
and tau follows Eq. 11: ceil(sqrt(F_t / F_0) * tau0), within [1, 64].

Aggregation is the plain gathered mean: the neighbour rows summed in slot
order in fp32, divided by the degree. Matrix products run in fp32 with TF32
off; ``precision="tf32"`` runs them in TF32 (on the CPU by rounding the
operands to TF32's 10-bit mantissa), the benchmark's control.

The random draws follow the seed as the program's documented draw order
gives them: one device generator seeded with the run's seed, and for each
member in cohort order and each epoch, the batch uniforms (n_max,) and then
the fanout uniforms (batch, max_deg). The sampling keys are quantized (the
low 12 mantissa bits dropped) and sorted stably, ties to the lower index,
as the program's discrete decisions are defined.

``follow``: a member's batches may be drawn from the probabilities of a
loss pass given from outside (the program's, read back from its
``prev_loss`` table), so that rounding in the loss pass cannot move a node
across the batch's boundary. The reference then still runs its own loss
pass, which the judge holds to the given one, and counts the epochs whose
batch its own probabilities would have drawn differently.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import numpy as np
import torch

HIDDEN = (256, 128)
# faults the reference can run with, in the program's place, to read what
# each makes of the compared numbers: every other valid batch row left out
# (the loss the mean over the rest), one node's loss altered where the loss
# pass produces it
FAULTS = (None, "half_batch", "altered_loss")
LEAVES = ("w_self0", "w_nbr0", "b0", "w_self1", "w_nbr1", "b1", "w_cls", "b_cls")
DROP_BITS = 12
GATHER_BYTES = 1 << 28      # a gathered block of neighbour rows at most this big


@dataclass(frozen=True)
class Method:
    sample_ratio: float = 0.7
    batch_cap: int = 256
    fanout: int = 10
    local_epochs: int = 4
    lr: float = 0.01
    tau0: int = 4
    weight_decay: float = 0.001


def batch_size(method: Method, n_max: int) -> int:
    return max(1, min(method.batch_cap, int(round(n_max * method.sample_ratio))))


def init_params(gen: torch.Generator, n_features: int, n_classes: int,
                device) -> dict:
    """The benchmark's initial weights: normal draws scaled by
    sqrt(2 / (fan_in + fan_out)) in one call on the generator's device,
    zero biases."""
    dims = (n_features, *HIDDEN)
    shapes = {}
    for l in range(len(HIDDEN)):
        shapes[f"w_self{l}"] = (dims[l], dims[l + 1])
        shapes[f"w_nbr{l}"] = (dims[l], dims[l + 1])
    shapes["w_cls"] = (HIDDEN[-1], n_classes)
    flat = torch.randn(sum(a * b for a, b in shapes.values()), generator=gen,
                       device=device, dtype=torch.float32)
    params, at = {}, 0
    for k, (a, b) in shapes.items():
        params[k] = (flat[at:at + a * b].view(a, b) * math.sqrt(2.0 / (a + b))).contiguous()
        at += a * b
    for l in range(len(HIDDEN)):
        params[f"b{l}"] = torch.zeros(dims[l + 1], device=device)
    params["b_cls"] = torch.zeros(n_classes, device=device)
    return {k: params[k] for k in LEAVES}


# -- arithmetic ------------------------------------------------------------

def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest), gradient passed
    straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


class Arith:
    """Matrix products in the run's precision."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"

    @contextlib.contextmanager
    def scope(self):
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32 and a.device.type == "cpu":
            a, b = _tf32_round(a), _tf32_round(b)
        return a @ b


def gather_mean(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of the live neighbour rows: (b, K) slots into ``table`` (M, D)."""
    b, k = idx.shape
    d = table.shape[1]
    deg = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    step = max(1, GATHER_BYTES // max(1, k * d * 4))
    if b <= step:
        return (table[idx.long()] * mask[..., None]).sum(1) / deg
    parts = [(table[idx[i:i + step].long()] * mask[i:i + step, :, None]).sum(1)
             for i in range(0, b, step)]
    return torch.cat(parts) / deg


def node_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def quantize(x: torch.Tensor) -> torch.Tensor:
    keep = ~((1 << DROP_BITS) - 1)
    return (x.contiguous().view(torch.int32) & keep).view(torch.float32)


def rank_of(keys: torch.Tensor) -> torch.Tensor:
    """Ascending stable rank of each slot of the last axis (quantized keys)."""
    order = torch.sort(quantize(keys), dim=-1, stable=True).indices
    ranks = torch.arange(keys.shape[-1], device=keys.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


def probabilities(loss: torch.Tensor, prev: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Eq. 8 over the training nodes ``mask``."""
    scores = torch.where(prev < 0.0, torch.abs(loss), torch.abs(loss - prev)) * mask
    s = scores * mask + 1e-8 * mask
    return s / torch.clamp(s.sum(), min=1e-30)


def gumbel_batch(u: torch.Tensor, probs: torch.Tensor, bsz: int, mask: torch.Tensor):
    logp = torch.log(torch.clamp(probs, min=1e-30)) + torch.where(mask > 0, 0.0, -1e30)
    key = quantize(logp + (-torch.log(-torch.log(u))))
    idx = torch.sort(key, descending=True, stable=True).indices[:bsz]
    return idx, mask[idx] > 0


def adaptive_tau(f_t: float, f_0: float, tau0: int) -> int:
    if f_0 <= 0.0 or not math.isfinite(f_t) or not math.isfinite(f_0):
        return tau0
    return max(1, min(64, math.ceil(math.sqrt(max(f_t, 0.0) / f_0) * tau0)))


# -- the model ---------------------------------------------------------------

def sage(ar: Arith, p: dict, l: int, h_self, h_agg):
    return torch.relu(ar.mm(h_self, p[f"w_self{l}"]) + ar.mm(h_agg, p[f"w_nbr{l}"]) + p[f"b{l}"])


def batch_forward(ar, p, feats, ghost, hist1, nbr_idx, nbr_mask, rows, keep=None, work=None,
                  backward=False):
    """Logits and fresh layer-1 rows of ``rows`` (Eq. 6): layer 0 over
    [feats | ghost], layer 1 over ``hist1`` with the fresh rows put in."""
    table0 = torch.cat([feats, ghost])
    b_idx, b_mask = nbr_idx[rows], nbr_mask[rows]
    if keep is not None:
        b_mask = b_mask * keep
    if work is not None:
        work.aggregation(b_idx, b_mask, table0.shape[0], feats.shape[1], backward=False)
        work.aggregation(b_idx, b_mask, table0.shape[0], HIDDEN[0], backward=backward)
    h1 = sage(ar, p, 0, feats[rows], gather_mean(table0, b_idx, b_mask))
    table1 = hist1.detach().index_put((rows,), h1)
    h2 = sage(ar, p, 1, h1, gather_mean(table1, b_idx, b_mask))
    return ar.mm(h2, p["w_cls"]) + p["b_cls"], h1


@torch.no_grad()
def adamw(p: dict, g: dict, mu: dict, nu: dict, step: int, lr: float, wd: float):
    b1, b2, eps = 0.9, 0.999, 1e-8
    one, t = np.float32(1.0), np.float32(step)
    b1c = float(one - np.float32(b1) ** t)
    b2c = float(one - np.float32(b2) ** t)
    out = {}
    for k in p:
        mu[k] = mu[k] * b1 + g[k] * (1.0 - b1)
        nu[k] = nu[k] * b2 + torch.square(g[k]) * (1.0 - b2)
        out[k] = p[k] - lr * ((mu[k] / b1c) / (torch.sqrt(nu[k] / b2c) + eps) + wd * p[k])
    return out


# -- inputs and state -------------------------------------------------------

def device_inputs(part: dict, graph: dict, eval_nbrs: tuple, device) -> dict:
    """The partition's client arrays and the eval graph on ``device``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    inp = {k: t(part[k]) for k in ("features", "labels", "node_mask", "train_mask",
                                   "nbr_idx", "nbr_mask", "ghost_owner", "ghost_row",
                                   "ghost_mask")}
    inp.update(n_max=part["n_max"], g_max=part["g_max"], n_clients=part["n_clients"],
               sizes=part["node_mask"].sum(1).astype(np.int64),
               eval_features=t(graph["features"]), eval_labels=t(graph["labels"]),
               eval_idx=t(eval_nbrs[0]), eval_mask=t(eval_nbrs[1]),
               test_mask=t(graph["test_mask"]))
    return inp


@dataclass
class MemberOut:
    params: dict
    hist1: torch.Tensor
    age: torch.Tensor
    ghost: torch.Tensor
    loss_all: torch.Tensor
    diverged_batches: int = 0


@dataclass
class RoundOut:
    members: list = field(default_factory=list)
    first_grad_norms: dict | None = None


class RefRun:
    """The reference's federation: params, tables and draws from the start
    of a run (or from a given state), advanced a round at a time."""

    def __init__(self, inp: dict, method: Method, params: dict, seed: int, device,
                 precision: str = "fp32", state: dict | None = None, fault: str | None = None):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
        self.inp, self.method, self.dev = inp, method, torch.device(device)
        self.ar = Arith(precision)
        self.fault = fault
        K, n_max, g_max = inp["n_clients"], inp["n_max"], inp["g_max"]
        self.F = inp["features"].shape[2]
        self.bsz = batch_size(method, n_max)
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(seed)
        if state is None:
            self.hist1 = torch.zeros((K, n_max + g_max, HIDDEN[0]), device=self.dev)
            self.age = torch.zeros((K, n_max + g_max), dtype=torch.int32, device=self.dev)
            self.prev_loss = torch.full((K, n_max), -1.0, device=self.dev)
            self.ghost = {}
        else:
            self.hist1, self.age = state["hist1"], state["age"]
            self.prev_loss, self.ghost = state["prev_loss"], state["ghost"]
            self.gen.set_state(state["gen"])

    def ghost_of(self, k: int) -> torch.Tensor:
        g = self.ghost.get(k)
        if g is None:
            return torch.zeros((self.inp["g_max"], self.F), device=self.dev)
        return g

    def member(self, k: int, hist1_all, tau: int, eoff: int, first: bool,
               follow=None, work=None) -> tuple:
        inp, me, ar = self.inp, self.method, self.ar
        n_max = inp["n_max"]
        feats, labels = inp["features"][k], inp["labels"][k]
        node_mask = inp["node_mask"][k]
        train = inp["train_mask"][k] * node_mask
        nbr_idx, nbr_mask = inp["nbr_idx"][k], inp["nbr_mask"][k]
        ghost_mask = inp["ghost_mask"][k]
        p = self.params
        hist1, age, ghost = self.hist1[k], self.age[k], self.ghost_of(k)
        every = torch.arange(n_max, device=self.dev)
        with torch.no_grad():
            logits, _ = batch_forward(ar, p, feats, ghost, hist1, nbr_idx, nbr_mask, every,
                                      work=work)
            loss_all = node_loss(logits, labels) * node_mask
            if self.fault == "altered_loss":
                loss_all[0] += 0.5
        own = probabilities(loss_all, self.prev_loss[k], train)
        probs = own if follow is None else probabilities(follow[0], follow[1], train)
        mu = {n: torch.zeros_like(v) for n, v in p.items()}
        nu = {n: torch.zeros_like(v) for n, v in p.items()}
        first_grads, diverged = None, 0
        for j in range(me.local_epochs):
            u = torch.rand((n_max,), generator=self.gen, device=self.dev).clamp_(min=1e-20)
            rows, valid = gumbel_batch(u, probs, self.bsz, train)
            if self.fault == "half_batch":
                valid = valid.clone()
                valid[valid.nonzero()[::2, 0]] = False
            if follow is not None:
                mine, _ = gumbel_batch(u, own, self.bsz, train)
                diverged += int(not torch.equal(torch.sort(mine).values,
                                                torch.sort(rows).values))
            b_mask = nbr_mask[rows]
            fu = torch.rand(tuple(b_mask.shape), generator=self.gen, device=self.dev)
            keep = (rank_of(torch.where(b_mask > 0, fu, 2.0)) < me.fanout).to(torch.float32)
            if (eoff + j) % max(tau, 1) == 0:
                b_idx = nbr_idx[rows]
                hit = (b_idx >= n_max) & (b_mask * keep > 0) & valid[:, None]
                slot = torch.where(hit, b_idx - n_max, 0).long().reshape(-1)
                need = torch.zeros_like(ghost_mask).scatter_reduce(
                    0, slot, hit.reshape(-1).to(ghost_mask.dtype), "amax") * ghost_mask
                owner = torch.clamp(inp["ghost_owner"][k], min=0).long()
                row = inp["ghost_row"][k].long()
                pulled = need[:, None] > 0
                ghost = torch.where(pulled, inp["features"][owner, row] * ghost_mask[:, None],
                                    ghost)
                hist1 = torch.cat([hist1[:n_max], torch.where(
                    pulled, hist1_all[owner, row] * ghost_mask[:, None], hist1[n_max:])])
            leaves = {n: v.detach().requires_grad_(True) for n, v in p.items()}
            logits, h1 = batch_forward(ar, leaves, feats, ghost, hist1, nbr_idx, nbr_mask,
                                       rows, keep, work=work, backward=True)
            w = valid.to(torch.float32) * train[rows]
            loss = (node_loss(logits, labels[rows]) * w).sum() / torch.clamp(w.sum(), min=1.0)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            if first and j == 0:
                first_grads = {n: float(torch.linalg.vector_norm(g.double()))
                               for n, g in grads.items()}
            p = adamw(p, grads, mu, nu, j + 1, me.lr, me.weight_decay)
            pushed = valid & (node_mask[rows] > 0)
            h1 = h1.detach()
            hist1 = hist1.index_put((rows,), torch.where(pushed[:, None], h1, hist1[rows]))
            age = (age + 1).index_put((rows,), torch.where(pushed, 0, age[rows] + 1))
        return MemberOut(p, hist1, age, ghost, loss_all, diverged), first_grads

    def round(self, t: int, cohort, tau: int, follow=None, work=None,
              grads: bool = False) -> RoundOut:
        """Round ``t`` over ``cohort`` (host ints) at sync interval ``tau``.
        ``follow``: per member, (loss pass, previous loss) to draw batches
        from. The first member's first gradient norms are kept in round 0,
        or with ``grads``."""
        out = RoundOut()
        hist1_all = self.hist1.clone()
        with self.ar.scope():
            for i, k in enumerate(cohort):
                mo, fg = self.member(int(k), hist1_all, tau, t * self.method.local_epochs,
                                     (t == 0 or grads) and i == 0,
                                     None if follow is None else follow[i], work)
                out.members.append(mo)
                if fg is not None:
                    out.first_grad_norms = fg
        m = torch.full((), len(cohort), dtype=torch.float32, device=self.dev)
        self.params = {n: torch.stack([mo.params[n] for mo in out.members]).sum(0) / m
                       for n in LEAVES}
        for k, mo in zip(cohort, out.members):
            k = int(k)
            self.hist1[k] = mo.hist1
            self.age[k] = mo.age
            self.ghost[k] = mo.ghost
            self.prev_loss[k] = mo.loss_all
        return out

    @torch.no_grad()
    def eval_logits(self, params: dict, work=None) -> torch.Tensor:
        inp, ar = self.inp, self.ar
        h = inp["eval_features"]
        with ar.scope():
            for l in range(len(HIDDEN)):
                if work is not None:
                    work.aggregation(inp["eval_idx"], inp["eval_mask"], h.shape[0], h.shape[1])
                h = sage(ar, params, l, h, gather_mean(h, inp["eval_idx"], inp["eval_mask"]))
            return ar.mm(h, params["w_cls"]) + params["b_cls"]

    def eval_loss(self, params: dict) -> float:
        logits = self.eval_logits(params)
        mask = self.inp["test_mask"]
        nll = node_loss(logits[mask].double(), self.inp["eval_labels"][mask])
        return float(nll.mean())
