"""The comparison that decides ``correct``: the driver's answers of a
sample of the window's iterations against the plain reference
(``reference.gp``), after the window has closed and the program's state is
freed.

The sample is one of the first two cycles of the window, drawn from the
seed (every cycle replays the same three iterations from the same saved
state).  For each of its iterations the harness kept what the driver
produced: the chain's walkers before the retrain, and after it with the
log posterior the chain reports for each; the ensemble's hyperparameters
and K^-1 y after the retrain; the points it holds; the recommendation; and
its own record of the data it handed over.  The reference works out
everything else again.

Readings (the worst over the sample's iterations):

- ``data_mismatch``: rows of the points the ensemble holds (padding
  included) that differ from the harness's data, bit for bit in the
  configuration's dtype; with derivative channels also the rows of the
  observed values the model holds (value and partials, before any
  scaling) that differ from the harness's, bit for bit.  Exact: its limit
  is 0.
- ``walkers_unmoved``: walkers of the chain whose position the retrain
  left as it was; every walker where the retrain ran no chain.  Exact:
  its limit is 0.
- ``chain_lml_err``: per walker, |the log posterior the chain reports at
  its end - the reference's log prior + LML there| (nats); 0 where both
  are -inf; NaN where the retrain ran no chain.
- ``post_err``: per member, the largest gap between the posterior mean
  that the K^-1 y judged gives and the reference's at the reported
  hyperparameters, on a lattice of the domain, the iteration's points and
  its recommendation (standardized units).
- ``rec_gap``: the reference's ensemble-mean posterior mean at the
  recommendation above its least value over the domain (standardized
  units; 0 where the recommendation is lower).
The configuration names the model the reference builds: ``objective``
and ``num_fidelity`` (``objectives.OBJECTIVES``), ``observations`` (the
observed partials, default none: then the value-only functions of
``reference.gp``, else its channel functions), ``kernel_name`` (the
reference has Matern 5/2 alone: :func:`supported` raises for another, and
for ``noisy`` or ``standardize`` false), ``shape_bucket`` and ``dtype``.  The cell's limits file names which
readings are compared and their limits.  The control
(``cmoe_bench.control``) is judged by the same readings and limits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cmoe_bench.reference import gp as ref

# the reference's lattice and refinement rounds for the recommendation's
# floor, and the lattice of post_err
GRID_POINTS = 16384
ROUNDS = 10
POST_POINTS = 1024

READINGS = ("data_mismatch", "walkers_unmoved", "chain_lml_err",
            "post_err", "rec_gap")
# the covariance kernels the reference has
KERNELS = ("matern_2.5",)


def supported(cfg: dict) -> None:
    """Raises ``ValueError`` for a configuration the reference cannot
    judge: a kernel it lacks, or a model without sampled noise or
    standardized values (the only model it builds)."""
    if cfg["kernel_name"] not in KERNELS:
        raise ValueError(f"kernel {cfg['kernel_name']!r}: the reference "
                         f"has {', '.join(KERNELS)}")
    for key in ("noisy", "standardize"):
        if cfg[key] is not True:
            raise ValueError(f"{key} {cfg[key]!r}: the reference samples "
                             "the noise and standardizes the values")


def sample_cycle(records: list, seed: int) -> list:
    """The iterations of the sampled cycle: cycle ``seed`` mod the number
    of complete recorded cycles."""
    per = max(r["pos"] for r in records) + 1
    cycles = sorted({r["cycle"] for r in records
                     if sum(q["cycle"] == r["cycle"] for q in records)
                     == per})
    if not cycles:
        cycles = sorted({r["cycle"] for r in records})
    pick = cycles[seed % len(cycles)]
    return [r for r in records if r["cycle"] == pick]


def _data_mismatch(held, data) -> float:
    """Rows of ``held`` (the points the ensemble holds) that differ from
    the data's, in ``held``'s dtype; every row where the shapes differ."""
    held = np.asarray(held)
    mine = data.x.astype(held.dtype)
    if held.shape != mine.shape:
        return float(max(held.shape[0], mine.shape[0]))
    return float(np.sum(np.any(held != mine, axis=1)))


def _values_mismatch(held, values) -> float:
    """Rows of ``held`` (the observed values the model holds) that differ
    from the harness's, bit for bit; every row where the shapes differ."""
    held, values = np.asarray(held), np.asarray(values)
    if held.shape != values.shape:
        return float(max(held.shape[0], values.shape[0]))
    return float(np.sum(np.any(held != values, axis=1)))


def _walkers_unmoved(before, after) -> float:
    before, after = np.asarray(before), np.asarray(after)
    if before.shape != after.shape:
        return float(max(before.shape[0], after.shape[0]))
    return float(np.sum(np.all(before == after, axis=1)))


def _lp_gap(lp, lp_ref) -> float:
    """The largest |lp - lp_ref|, 0 where both are -inf, NaN where either
    is NaN."""
    lp = np.asarray(lp, dtype=float)
    lp_ref = np.asarray(lp_ref, dtype=float)
    if lp.shape != lp_ref.shape or np.isnan(lp).any() or \
            np.isnan(lp_ref).any():
        return math.nan
    both = np.isneginf(lp) & np.isneginf(lp_ref)
    gap = np.where(both, 0.0, np.abs(np.where(both, 0.0, lp) -
                                     np.where(both, 0.0, lp_ref)))
    return float(np.max(gap))


class Judge:
    """The reference's side of one cell: its configuration, its domain
    and the device the reference runs on."""

    def __init__(self, cfg: dict, domain, device):
        supported(cfg)
        self.cfg = cfg
        self.derivatives = tuple(cfg.get("observations", []))
        self.num_fidelity = int(cfg["num_fidelity"])
        self.device = torch.device(device)
        self.domain = np.asarray(domain, dtype=float)
        self.jitter = ref.F32_JITTER if cfg["dtype"] == "float32" else 0.0
        self.lattice = ref.lattice(self.domain, POST_POINTS, self.device)[0]

    def t(self, x) -> torch.Tensor:
        return ref.t64(x, self.device)

    def rec_gap(self, ens, rec) -> float:
        """The ensemble mean at ``rec`` above its least value over the
        domain."""
        floor = float(ref.recommend(ens, self.domain, GRID_POINTS,
                                    ROUNDS, self.num_fidelity)[1])
        at = float(torch.mean(ref.posterior_mean(ens, self.t(rec[None]))))
        return max(at - floor, 0.0)

    def post_err(self, ens, alpha, x) -> float:
        return float(torch.max(torch.abs(
            ref.posterior_mean(ens, x, self.t(alpha)) -
            ref.posterior_mean(ens, x))))

    def chain_lp(self, data, thetas) -> np.ndarray:
        t = self.t(thetas)
        lp = ref.log_prior(t)
        return torch.where(torch.isneginf(lp), lp,
                           lp + ref.chain_lml(data, t)).cpu().numpy()

    def chain_lp_channels(self, data, thetas) -> np.ndarray:
        t = self.t(thetas)
        lp = ref.log_prior_channels(t, self.domain.shape[0])
        return torch.where(torch.isneginf(lp), lp,
                           lp + ref.chain_lml_channels(data, t)).cpu().numpy()

    def readings_channels(self, rec: dict) -> dict:
        """:meth:`readings` of an iteration with derivative channels; NaN
        but ``data_mismatch`` where the harness's values lack a channel."""
        if np.shape(rec["values"])[1:] != (1 + len(self.derivatives),):
            return dict(dict.fromkeys(READINGS, math.nan),
                        data_mismatch=_values_mismatch(rec["held_values"],
                                                       rec["values"]))
        data = ref.prepare_channels(rec["points"], rec["values"],
                                    self.cfg["shape_bucket"],
                                    self.derivatives)
        ens = ref.fit_channels(data, rec["hypers"], rec["noises"],
                               self.jitter, self.device)
        x = torch.cat([self.lattice, self.t(rec["picks"]),
                       self.t(rec["recommended"][None])])
        ran = rec["chain_pos"] is not None
        walkers = rec["chain_pos"] if ran else rec["walkers_before"]
        alpha = np.asarray(rec["alpha"])
        return {
            "data_mismatch": _data_mismatch(rec["held_points"], data) +
            _values_mismatch(rec["held_values"], rec["values"]),
            "walkers_unmoved": _walkers_unmoved(rec["walkers_before"],
                                                walkers),
            "chain_lml_err": _lp_gap(rec["chain_lp"], self.chain_lp_channels(
                data, walkers)) if ran else math.nan,
            "post_err": self.post_err(ens, alpha, x)
            if alpha.shape == tuple(ens.alpha.shape) else math.inf,
            "rec_gap": self.rec_gap(ens, rec["recommended"])}

    def readings(self, rec: dict) -> dict:
        """{name: value} of one recorded iteration."""
        if self.derivatives:
            return self.readings_channels(rec)
        data = ref.prepare(rec["points"], rec["values"],
                           self.cfg["shape_bucket"])
        ens = ref.fit(data, rec["hypers"], rec["noises"], self.jitter,
                      self.device)
        x = torch.cat([self.lattice, self.t(rec["picks"]),
                       self.t(rec["recommended"][None])])
        ran = rec["chain_pos"] is not None
        walkers = rec["chain_pos"] if ran else rec["walkers_before"]
        return {
            "data_mismatch": _data_mismatch(rec["held_points"], data),
            "walkers_unmoved": _walkers_unmoved(rec["walkers_before"],
                                                walkers),
            "chain_lml_err": _lp_gap(rec["chain_lp"], self.chain_lp(
                data, walkers)) if ran else math.nan,
            "post_err": self.post_err(ens, rec["alpha"], x),
            "rec_gap": self.rec_gap(ens, rec["recommended"])}


def judge(records: list, cfg: dict, domain, seed: int, device) -> dict:
    """{name: the worst over the sampled iterations}, NaN where any
    iteration read NaN."""
    j = Judge(cfg, domain, device)
    out: dict = {}
    for rec in sample_cycle(records, seed):
        for name, v in j.readings(rec).items():
            old = out.get(name, -math.inf)
            out[name] = v if math.isnan(v) or v > old else old
    return out


def compare(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}} for each reading the limits
    name; a reading that is missing or not finite fails."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
