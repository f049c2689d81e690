"""How ``correct`` is decided: what the timed path produced, held against
the plain reference (``bench/reference``) in float64.

What the port's fused blocks let one read: each round's scores, FedBWO's
winner or FedAvg's participants and the evaluation loss (the block's
logs), the global model at the end of each block, and ``CommMeter``'s
ledger.  So the reference

* follows the first ``follow_rounds`` rounds of the set-up block from the
  benchmark's initial model, through every layer (local SGD with its
  dropout draws, FedBWO's seeding and generations with the kernel route's
  draws, the server's choice and adoption or average, the evaluation),
  and compares each round's scores, winner and evaluation loss;
* takes the model the program holds at the end of the set-up block and of
  the window's last block (the program's own state, which it cannot
  follow further without the rounds the blocks keep to themselves) and
  checks the last round's claims about it: FedBWO's winner reported a
  fitness that is this model's on its own batches, and the evaluation
  loss is this model's;
* checks every round's winner against its scores, and the byte ledger
  against Eqs. 1-2 exactly.

Every number has a limit in ``bench/limits/<cell>.json``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from bench import counts
from bench.reference import fl, threefry as tf

SCORE_BYTES = 4


@dataclasses.dataclass
class Observed:
    """What one run produced: the first block's rounds (from the initial
    model), the models at block ends with the info of the round that made
    each, every round's info, and the byte ledger."""
    first: List[dict]
    ends: List[tuple]
    rounds: List[dict]
    uplink: Optional[List[int]] = None
    downlink: Optional[List[int]] = None


def round_hp(traffic: dict) -> fl.RoundHP:
    return fl.RoundHP(local_epochs=traffic["local_epochs"], lr=traffic["lr"],
                      fitness_batches=traffic["fitness_batches"],
                      pop=traffic["mh_pop"],
                      generations=traffic["mh_generations"])


def server_key(seed: int) -> tuple:
    """The server's round key: the seed's key, split once (the other half
    seeds the port's own initialisation, which the benchmark replaces)."""
    return tf.split(tf.key_from_seed(seed))[0]


def info_of(out: fl.RoundOut, eval_loss: float) -> dict:
    info = {"scores": [float(s) for s in out.scores],
            "eval_loss": eval_loss}
    if out.best is not None:
        info["best_client"] = out.best
    else:
        info["participants"] = [int(k) for k in out.participants]
    return info


def reference_rounds(model: fl.Model, inputs, seed: int, traffic: dict,
                     n_rounds: int, faults: frozenset = frozenset()):
    """``n_rounds`` rounds of the reference from the benchmark's initial
    model: ``(infos, params after each round)``.  ``faults`` plants the
    faults a run can have, for the check's own readings: ``skip_sgd`` (a
    client step that returns its state), ``tail_skip_sgd`` (the same in the
    last tenth of the clients only), ``keep_state`` (the server keeps the
    old model), ``flip_best`` (the winner reported one client on)."""
    hp = round_hp(traffic)
    n_part = counts.n_participants(traffic)
    flat = inputs.weights.to(model.precision.dtype)
    rng = server_key(seed)
    infos, params = [], []
    for _ in range(n_rounds):
        out = fl.fl_round(model, flat, inputs.clients, rng, hp,
                          traffic["strategy"], n_part,
                          skip_sgd="skip_sgd" in faults,
                          keep_state="keep_state" in faults,
                          skip_tail="tail_skip_sgd" in faults)
        rng, flat = out.rng, out.params
        info = info_of(out, model.evaluate(flat, inputs.eval)[0])
        if out.members is not None:
            # each client's model, for judging a winner that a near-tie
            # gave to another client than the reference's
            info["eval_by_client"] = [model.evaluate(m, inputs.eval)[0]
                                      for m in out.members]
        if "flip_best" in faults and out.best is not None:
            info["best_client"] = (out.best + 1) % len(out.scores)
        infos.append(info)
        params.append(flat)
    return infos, params


def observe_reference(model, inputs, seed, traffic, n_rounds, faults=()):
    """The reference (or the control, in its precision) in the program's
    place: its first ``n_rounds`` rounds, its model at their end."""
    infos, params = reference_rounds(model, inputs, seed, traffic, n_rounds,
                                     frozenset(faults))
    return Observed(first=infos, ends=[(params[-1], infos[-1])],
                    rounds=infos)


def _rel(a: float, b: float) -> float:
    """The gap between two losses, relative to the reference's loss or to
    1 nat, whichever is larger: a float32 loss near 0 (a well-trained
    model's) carries an absolute rounding, not a relative one."""
    return abs(a - b) / max(abs(b), 1.0)


def ledger_error(obs: Observed, traffic: dict, model_bytes: int) -> int:
    """Bytes by which the ledger departs from Eq. 2 (FedX: n scores of 4
    bytes plus the winner's model up, the model to each client down) or
    Eq. 1 (FedAvg: each participant's model up and down), summed over the
    rounds, plus a round's worth for each round missing from it."""
    n = traffic["n_clients"]
    if traffic["strategy"] == "fedavg":
        m = counts.n_participants(traffic)
        up, down = m * model_bytes, m * model_bytes
    else:
        up, down = n * SCORE_BYTES + model_bytes, n * model_bytes
    err = sum(abs(u - up) for u in obs.uplink) + \
        sum(abs(d - down) for d in obs.downlink)
    return err + abs(len(obs.rounds) - len(obs.uplink)) * (up + down)


def numbers(model: fl.Model, inputs, seed: int, traffic: dict,
            obs: Observed, follow_rounds: int, follow=None) -> dict:
    """The compared numbers (``follow``: the float64 reference's own first
    rounds, when already run)."""
    if follow is None:
        follow = reference_rounds(model, inputs, seed, traffic,
                                  follow_rounds)[0]
    fedbwo = traffic["strategy"] == "fedbwo"
    out = {}
    score_gaps, eval_gaps, picks, winner = [], [], 0, 0.0
    for got, want in zip(obs.first[:follow_rounds], follow):
        if fedbwo:
            ref = want["scores"]
            best = got["best_client"]
            winner = max(winner, _rel(ref[best], min(ref)))
            score_gaps += [_rel(s, t) for s, t in zip(got["scores"], ref)]
        else:
            picks += got["participants"] != want["participants"]
            by_client = dict(zip(want["participants"], want["scores"]))
            score_gaps += [_rel(s, by_client.get(k, np.inf))
                           for k, s in zip(got["participants"],
                                           got["scores"])]
        # FedBWO: the model of the client the program chose, as the
        # reference has it
        want_eval = (want["eval_by_client"][got["best_client"]]
                     if fedbwo else want["eval_loss"])
        eval_gaps.append(_rel(got["eval_loss"], want_eval))
    out["score_gap"] = max(score_gaps)
    out["score_gap_median"] = float(np.median(score_gaps))
    # the gap that the worst tenth of the clients reach: a fault confined
    # to a few clients, which leaves the median client alone
    out["score_gap_p90"] = float(
        np.sort(score_gaps)[-fl.tail_size(len(score_gaps))])
    out["round_eval_gap"] = max(eval_gaps)
    if fedbwo:
        out["winner_gap"] = winner
    else:
        out["participants_miss"] = picks
    out.update(end_numbers(model, inputs, traffic, obs))
    if obs.uplink is not None:
        out["bytes_off"] = ledger_error(obs, traffic, 4 * model.dim)
    return out


def end_numbers(model: fl.Model, inputs, traffic: dict,
                obs: Observed) -> dict:
    """The checks on the program's own state at block ends, and on every
    round's winner."""
    fedbwo = traffic["strategy"] == "fedbwo"
    out = {}
    fit_gaps, end_gaps = [], []
    for flat, info in obs.ends:
        flat = flat.to(model.precision.dtype)
        end_gaps.append(_rel(info["eval_loss"],
                             model.evaluate(flat, inputs.eval)[0]))
        if fedbwo:
            k = info["best_client"]
            fit_gaps.append(_rel(info["scores"][k], model.fitness(
                flat, inputs.clients[k], traffic["fitness_batches"])))
    out["eval_gap"] = max(end_gaps)
    if fedbwo:
        out["fitness_gap"] = max(fit_gaps)
        out["argmin_miss"] = sum(
            int(r["best_client"] != int(np.argmin(r["scores"])))
            for r in obs.rounds)
    return out


def judge(found: dict, limits: dict):
    """``(correct, rows)``: each compared number beside its limit; a number
    is within when it is at most its limit (and a number, not NaN)."""
    rows = {}
    ok = True
    for name, limit in limits.items():
        value = found.get(name)
        within = value is not None and bool(value <= limit)
        ok &= within
        rows[name] = {"value": value, "limit": limit}
    return ok, rows
