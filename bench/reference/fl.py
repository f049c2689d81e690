"""Plain federated rounds: the reference the benchmark holds the port to.

Written from the algorithms (FedAvg, McMahan et al. 2017; FedBWO,
arXiv:2505.04435, Algorithms 2-3 with BWO's generation as mutation ->
procreation -> cannibalism) and the key schedule the configuration
states, one client after another, in a stated precision: float64, or
float32 with TF32 products (the control).  Nothing here imports the port.

A model is a flat genome vector plus the layout of its leaves; a batch is
a dict of tensors with a leading sample axis (its keys are the model
module's), and a client dataset the same dict with ``(n_batches, B)``
leading axes.  Keys are threefry word pairs (``threefry``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
from typing import Callable, Optional

import numpy as np
import torch

from bench.reference import threefry as tf

# FedBWO's constants (arXiv:2505.04435 §III-C): a member's mutation
# probability, the cannibalism rate, a gene's mutation probability, the
# mutation's scale, the share of the population that procreates, and the
# seeding's spread around the trained model.
BWO = {"pm": 0.4, "pc": 0.44, "pm_gene": 0.1, "mut_scale": 0.05,
       "procreate_frac": 0.6, "init_spread": 0.02}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away),
    passing the gradient through: the control's products on a device
    without TF32."""
    if x.dtype != torch.float32:
        return x
    i = x.detach().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


@dataclasses.dataclass
class Precision:
    """float64, or the control: float32 with TF32 products (the card's own
    TF32, or ``tf32_round`` on the CPU)."""
    name: str = "float64"

    @property
    def dtype(self):
        return torch.float64 if self.name == "float64" else torch.float32

    def mm(self, device) -> Callable:
        if self.name == "tf32" and torch.device(device).type == "cpu":
            return tf32_round
        return lambda x: x

    @contextlib.contextmanager
    def products(self, device):
        """TF32 on for the control's products on the card."""
        if self.name != "tf32" or torch.device(device).type != "cuda":
            yield
            return
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def leading(data: dict) -> int:
    """The length of the dict's leading axis (every tensor shares it)."""
    return next(iter(data.values())).shape[0]


def batch_at(data: dict, i: int) -> dict:
    """Batch ``i`` of a client dataset."""
    return {k: v[i] for k, v in data.items()}


class Model:
    """A configuration's plain model (``bench/models/<model>.py``) on a
    device, in a precision.  ``half_batch`` plants a fault (the loss over
    the first half of each batch: every tensor of the dict halved), for
    the check's own tests."""

    def __init__(self, cfg: dict, device, precision: Precision,
                 half_batch: bool = False):
        self.cfg = cfg
        self.mod = importlib.import_module(f"bench.models.{cfg['model']}")
        self.layout = self.mod.layout(cfg)
        self.sizes = [math.prod(s) for _, s in self.layout]
        self.device = torch.device(device)
        self.precision = precision
        self.mm = precision.mm(device)
        self.half_batch = half_batch

    @property
    def dim(self) -> int:
        return sum(self.sizes)

    def unravel(self, flat):
        parts = torch.split(flat, self.sizes)
        return {name: p.reshape(shape)
                for (name, shape), p in zip(self.layout, parts)}

    def loss(self, p: dict, batch: dict, keep=None):
        """The model module's mean loss and accuracy of a batch, its
        floating tensors in the precision's type."""
        if self.half_batch:
            h = leading(batch) // 2
            batch = {k: v[:h] for k, v in batch.items()}
            keep = None if keep is None else keep[:h]
        dt = self.precision.dtype
        batch = {k: v.to(dt) if v.is_floating_point() else v
                 for k, v in batch.items()}
        return self.mod.loss(self.cfg, p, batch, keep, self.mm)

    def evaluate(self, flat, batch: dict):
        with torch.no_grad(), self.precision.products(self.device):
            loss, acc = self.loss(self.unravel(flat), batch)
        return float(loss), float(acc)

    def fitness(self, flat, data: dict, n_batches: int) -> float:
        """Mean loss over the first ``n_batches`` batches (a client with
        fewer repeats its last one)."""
        nb = leading(data)
        p = self.unravel(flat)
        with torch.no_grad(), self.precision.products(self.device):
            losses = [self.loss(p, batch_at(data, min(i, nb - 1)))[0]
                      for i in range(n_batches)]
        return float(torch.stack(losses).mean())


@dataclasses.dataclass(frozen=True)
class RoundHP:
    """A round's hyper-parameters, as the traffic mix states them."""
    local_epochs: int
    lr: float
    fitness_batches: int
    pop: int = 0
    generations: int = 0
    bwo: dict = dataclasses.field(default_factory=lambda: dict(BWO))


def _dropout_keys(key, epochs: int, n_batches: int) -> np.ndarray:
    """The dropout key of every SGD step of one client, in step order:
    each epoch splits ``(key, epoch key)``, each batch splits the epoch's
    carry into ``(next carry, dropout key)``."""
    out = []
    for _ in range(epochs):
        key, k = tf.split(key)
        for _ in range(n_batches):
            k, dkey = tf.split(k)
            out.append(dkey)
    return np.array(out, dtype=np.int64)


def local_sgd(model: Model, flat, data: dict, key, hp: RoundHP,
              skip: bool = False):
    """Plain SGD over the client's batches for ``hp.local_epochs`` epochs,
    one dropout mask a step; ``skip`` plants a fault (no step taken)."""
    nb, B = next(iter(data.values())).shape[:2]
    shape = model.mod.dropout_shape(model.cfg, B)
    dkeys = _dropout_keys(key, hp.local_epochs, nb)
    masks = None
    if shape is not None:
        n = math.prod(shape)
        masks = bernoulli_rows(dkeys, 1.0 - model.cfg["dropout"], n,
                               model.device).reshape(-1, *shape)
    if skip:
        return flat
    flat = flat.detach()
    with model.precision.products(model.device):
        for s in range(len(dkeys)):
            i = s % nb
            leaves = [t.requires_grad_() for t in
                      torch.split(flat.clone(), model.sizes)]
            p = {name: t.reshape(shape_)
                 for (name, shape_), t in zip(model.layout, leaves)}
            loss = model.loss(p, batch_at(data, i),
                              None if masks is None else masks[s])[0]
            grads = torch.autograd.grad(loss, leaves)
            flat = torch.cat([(t - hp.lr * g).detach().reshape(-1)
                              for t, g in zip(leaves, grads)])
    return flat


def bernoulli_rows(keys: np.ndarray, p: float, n: int, device):
    """``bernoulli(keys[j], p, (n,))`` for each key, drawn on ``device``."""
    k = torch.as_tensor(keys, dtype=torch.int64, device=device)
    hi, lo = (torch.zeros(1, n, dtype=torch.int64, device=device),
              torch.arange(n, dtype=torch.int64, device=device)[None])
    y1, y2 = tf.hash2x32(k[:, :1], k[:, 1:], hi, lo)
    return tf.unit_float(y1 ^ y2) < float(np.float32(p))


def _stable_order(values) -> np.ndarray:
    return np.argsort(np.asarray(values, dtype=np.float64), kind="stable")


def bwo_generation(model: Model, pop, fit, key, hp: RoundHP, fit_fn):
    """One FedBWO generation on a (P, D) population: mutation of the first
    parent, alpha-crossover with the second (both drawn from the fittest
    ``procreate_frac``), then cannibalism: the best ``1 - pc`` of the
    children join the parents and the best P survive.  The draws are the
    kernel route's: the key splits five ways, parent positions by randint,
    two bit planes at the 128-padded width, a row gate by bernoulli."""
    b = hp.bwo
    P, D = pop.shape
    r_sel1, r_sel2, r_b1, r_b2, r_gate = tf.split(key, 5)
    n_par = max(2, int(P * b["procreate_frac"]))
    order = _stable_order(fit)
    p1 = order[tf.randint(r_sel1, (P,), 0, n_par)]
    p2 = order[tf.randint(r_sel2, (P,), 0, n_par)]
    Dp = -(-D // 128) * 128
    dev = pop.device
    b1 = tf.bits(r_b1, (P, Dp), dev)[:, :D]
    b2 = tf.bits(r_b2, (P, Dp), dev)[:, :D]
    gate = torch.as_tensor(tf.bernoulli(r_gate, b["pm"], (P, 1)),
                           device=dev).to(pop.dtype)
    par1 = pop[torch.as_tensor(p1, device=dev)]
    par2 = pop[torch.as_tensor(p2, device=dev)]
    mask = ((b2 & 0xFF) < int(b["pm_gene"] * 256)).to(pop.dtype)
    u = ((b2 >> 8) & 0xFFFFFF).to(pop.dtype) / float(1 << 24)
    del b2
    noise = (2.0 * u - 1.0) * b["mut_scale"] * (par1.abs() + 1e-3)
    mutated = par1 + noise * mask * gate
    del noise, mask, u
    # the 32-bit word rounded to float32, as the update reads it
    alpha = b1.to(torch.float32).to(pop.dtype) / 4294967296.0
    del b1
    children = alpha * mutated + (1.0 - alpha) * par2
    child_fit = fit_fn(children)
    n_surv = max(1, int(P * (1 - b["pc"])))
    surv = _stable_order(child_fit)[:n_surv]
    all_fit = np.concatenate([fit, child_fit[surv]])
    keep = _stable_order(all_fit)[:P]
    all_pop = torch.cat([pop, children[torch.as_tensor(surv, device=dev)]])
    return all_pop[torch.as_tensor(keep, device=dev)], all_fit[keep]


def fedbwo_client(model: Model, flat, data: dict, key, hp: RoundHP,
                  skip_sgd: bool = False):
    """One FedBWO client: local SGD, a population seeded around the trained
    model (member 0 the model itself), ``hp.generations`` generations.
    -> (best fitness, best member)."""
    r_sgd, r_mh = tf.split(key)
    x0 = local_sgd(model, flat, data, r_sgd, hp, skip=skip_sgd)

    def fit_fn(pop):
        return np.array([model.fitness(m, data, hp.fitness_batches)
                         for m in pop])

    spread = hp.bwo["init_spread"]
    noise = tf.normal(r_mh, (hp.pop, x0.shape[0]), x0.device, x0.dtype)
    noise = noise * spread * (x0.abs() + 1e-3)[None]
    noise[0] = 0
    pop = x0[None] + noise
    del noise
    fit = fit_fn(pop)
    rng = r_mh
    for _ in range(hp.generations):
        rng, k = tf.split(rng)
        pop, fit = bwo_generation(model, pop, fit, k, hp, fit_fn)
    i = int(np.argmin(fit))
    return float(fit[i]), pop[i]


def fedavg_client(model: Model, flat, data: dict, key, hp: RoundHP,
                  skip_sgd: bool = False):
    """One FedAvg client: local SGD; its score is the trained model's
    fitness.  -> (score, trained model)."""
    r_sgd, _ = tf.split(key)
    x = local_sgd(model, flat, data, r_sgd, hp, skip=skip_sgd)
    return model.fitness(x, data, hp.fitness_batches), x


@dataclasses.dataclass
class RoundOut:
    rng: tuple
    scores: np.ndarray            # in the order the protocol reports them
    best: Optional[int]           # FedBWO's winner
    participants: Optional[np.ndarray]   # FedAvg's
    params: torch.Tensor          # the new global model (flat)
    members: Optional[list] = None  # FedBWO: each client's best member


def tail_size(n: int) -> int:
    """A tenth of ``n`` clients, rounded up: how many ``skip_tail``
    breaks and how far down ``check``'s ``score_gap_p90`` reads."""
    return max(1, -(-n // 10))


def fl_round(model: Model, flat, clients, rng, hp: RoundHP, strategy: str,
             n_participants: int, skip_sgd: bool = False,
             keep_state: bool = False, skip_tail: bool = False) -> RoundOut:
    """One round from the server's key: ``split(rng, n + 2) -> (next rng,
    selection key, one key a client)``.  FedBWO: every client updates and
    reports its best fitness; the server adopts the lowest scorer's model.
    FedAvg: the participants (a permutation's prefix) update; the server
    takes the mean of their models.  ``keep_state`` plants a fault (the
    global model is not replaced), ``skip_tail`` another (the last
    ``tail_size`` clients of the round's order skip their SGD)."""
    n = len(clients)
    keys = tf.split(rng, n + 2)
    rng, sel_key, ckeys = keys[0], keys[1], keys[2:]
    if strategy == "fedbwo":
        scores, members = [], []
        for k, data in enumerate(clients):
            skip = skip_sgd or (skip_tail and k >= n - tail_size(n))
            s, x = fedbwo_client(model, flat, data, ckeys[k], hp, skip)
            scores.append(s)
            members.append(x)
        best = int(np.argmin(scores))
        new = flat if keep_state else members[best]
        return RoundOut(rng, np.array(scores), best, None, new, members)
    sel = tf.permutation(sel_key, n)[:n_participants]
    scores, total = [], None
    for i, k in enumerate(sel):
        skip = skip_sgd or (skip_tail and i >= len(sel) - tail_size(len(sel)))
        s, x = fedavg_client(model, flat, clients[k], ckeys[k], hp, skip)
        scores.append(s)
        total = x if total is None else total + x
    new = flat if keep_state else total / len(sel)
    return RoundOut(rng, np.array(scores), None, np.array(sel), new)
