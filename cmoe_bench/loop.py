"""The general generator of the benchmark's traffic: closed-loop iterations
of ``BayesianOptimizer`` in cycles replayed from one saved state.

A traffic mix (``traffic/<mix>.json``) sets:

- ``points``: "uniform", the one kind so far: q points drawn uniformly
  over the domain by the harness's seed, the same q for a cycle position
  in every cycle, then ``observe``;
- ``iterations_per_cycle``: iterations between two restores of the state
  that set-up saved (every cycle replays the same shapes and draws);
- ``recommend_points``: the uniform guesses of each ``recommend``.

The objective is the configuration's (``objective``, ``observations``,
``num_fidelity``; ``objectives.Objective``).  The data the harness keeps
for the check are the points it handed over and the values: (n,) where
only the value is observed, else (n, 1 + m), the value and the observed
partials in their order.

Every iteration ends with ``recommend``.  Set-up (:meth:`Loop.setup`)
initializes the driver on the configuration's design, saves its state
through the port's ``save_checkpoint`` to a file under ``TMPDIR``, runs
one cycle to build and warm every program the window replays, and
restores.  The window (:meth:`Loop.window`) runs cycles, each after a
restore through the port's ``resume``, until ``seconds`` have passed; a
restore is outside the timed iterations.  Each iteration is timed on the
host from its first call into the driver to its recommendation, with the
device synced at the end of every span.

While a :class:`Loop` lives, the port's chain functions
(``run_ensemble_mcmc`` and its gated twin in ``models.mcmc``) are wrapped
so that the harness keeps what the last chain returned: its walkers and
the log posterior it reports for each.  The wrapper only holds the
returned tensors; they are read after the iteration's clock has stopped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from cmoe_bench.objectives import Objective

# iterations whose answers are kept for the check: the first two cycles
RECORDED_CYCLES = 2
CHAIN_FUNCTIONS = ("run_ensemble_mcmc", "run_ensemble_mcmc_gated")


class Spans:
    """The benchmark's spans: host seconds per name, each ended by a
    device sync, and a ``cmoe.<name>`` range for the profiler."""

    def __init__(self, device):
        self.device = torch.device(device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, into: dict):
        t0 = time.perf_counter()
        with torch.profiler.record_function("cmoe." + name):
            yield
            self.sync()
        into[name] = time.perf_counter() - t0


class Loop:
    """One cell's driver, objective and cycle on ``device``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from cornell_moe_tpu_torch import bayes_opt
        if traffic["points"] != "uniform":
            raise ValueError(f"points {traffic['points']!r}")
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.objective = Objective(cfg["objective"],
                                   cfg.get("observations", []),
                                   cfg["num_fidelity"])
        self.spans = Spans(device)
        self.per_cycle = int(traffic["iterations_per_cycle"])
        sgd = dataclasses.replace(bayes_opt.DEFAULT_SGD_PARAMS_KG,
                                  num_multistarts=cfg["num_multistarts"])
        self._dir = tempfile.mkdtemp(prefix="cmoe_bench_")
        self.bo = bayes_opt.BayesianOptimizer(
            objective_func=self.objective, method=cfg["method"],
            num_to_sample=cfg["num_to_sample"], num_mc=cfg["num_mc"],
            n_hypers=cfg["n_hypers"], chain_length=cfg["chain_length"],
            burnin_steps=cfg["burnin_steps"], noisy=cfg["noisy"],
            kernel_name=cfg["kernel_name"], sgd_params=sgd,
            seed=seed % (2 ** 63), verbose=False,
            checkpoint_path=os.path.join(self._dir, "state.npz"),
            shape_bucket=cfg["shape_bucket"],
            chain_gate_tol=cfg["chain_gate_tol"],
            standardize=cfg["standardize"], device=self.device,
            dtype=getattr(torch, cfg["dtype"]))
        rng = np.random.default_rng(seed % (2 ** 63))
        dom = self.objective._search_domain
        self._uniform = [rng.uniform(dom[:, 0], dom[:, 1],
                                     (cfg["num_to_sample"], dom.shape[0]))
                         for _ in range(self.per_cycle)]
        self._design = 0          # entries of the objective's log at n0
        self._mark = 0            # log entries before this cycle's
        self.iterations: list = []
        self.records: list = []
        self._chain = None
        self._wrapped = self._wrap_chain()

    def _wrap_chain(self) -> dict:
        """Wrap the port's chain functions to keep the last chain's
        (walkers, log posteriors); returns the originals."""
        from cornell_moe_tpu_torch.models import mcmc
        originals = {name: getattr(mcmc, name) for name in CHAIN_FUNCTIONS}

        def keeping(fn):
            def chain(*args, **kwargs):
                out = fn(*args, **kwargs)
                self._chain = (out[0], out[1])
                return out
            return chain
        for name, fn in originals.items():
            setattr(mcmc, name, keeping(fn))
        return originals

    @property
    def domain(self) -> np.ndarray:
        return self.objective._search_domain

    def data(self):
        """The harness's record of the data the driver holds now: the
        design and this cycle's observations, as points (n, d) and values:
        (n,) where only the value is observed, else (n, 1 + m), the value
        and the observed partials in their order."""
        log = self.objective.log
        rows = log[:self._design] + log[self._mark:]
        channels = self.objective.channels
        if len(channels) == 1:
            return (np.array([p for p, _ in rows]),
                    np.array([v[0] for _, v in rows]))
        return (np.array([p for p, _ in rows]),
                np.array([v[channels] for _, v in rows]))

    def setup(self) -> dict:
        """Returns the seconds of its parts."""
        parts = {}
        with self.spans.span("initialize", parts):
            self.bo.initialize(self.cfg["num_init_pts"])
        self._design = self._mark = len(self.objective.log)
        with self.spans.span("save", parts):
            self.bo.save_checkpoint(0)
        with self.spans.span("warm_cycle", parts):
            for pos in range(self.per_cycle):
                self.iteration(-1, pos)
        with self.spans.span("restore", parts):
            self.restore()
        return parts

    def restore(self) -> None:
        """The saved state back through ``resume``, its ensemble fit run
        eagerly (``programs.CAPTURE`` "never" for the call), so that the
        restore builds no program of its own."""
        from cornell_moe_tpu_torch.ops import programs
        before = programs.CAPTURE
        programs.CAPTURE = "never"
        try:
            self.bo.resume()
        finally:
            programs.CAPTURE = before
        self.spans.sync()
        self._mark = len(self.objective.log)

    def iteration(self, cycle: int, pos: int) -> dict:
        """One timed iteration; its answers kept when ``cycle`` is one of
        the recorded ones."""
        bo, span, it = self.bo, self.spans.span, {"cycle": cycle,
                                                  "pos": pos}
        keep = 0 <= cycle < RECORDED_CYCLES
        if keep:
            walkers_before = bo.model.p0.detach().cpu().numpy()
        self._chain = None
        t0 = time.perf_counter()
        picks = self._uniform[pos]
        evaluated = self.objective.seconds
        with span("observe", it):
            bo.observe(picks)
        it["evaluate"] = self.objective.seconds - evaluated
        with span("recommend", it):
            rec = bo.recommend(self.traffic["recommend_points"])
        it["seconds"] = time.perf_counter() - t0
        model = bo.model
        it["chain_steps"] = int(model.last_chain_steps)
        it["walkers"] = int(model.n_hypers)
        it["padded_n"] = int(model.models.points_sampled.shape[-2])
        it["ensemble"] = int(model.models.chol_K.shape[0])
        it["fits"] = 2 + int(model.members_replaced[-1] > 0)
        it["finite"] = bool(np.all(np.isfinite(rec)))
        if keep:
            points, values = self.data()
            states = model.models
            chain_pos, chain_lp = (None, None) if self._chain is None else (
                t.detach().cpu().numpy() for t in self._chain)
            self.records.append({
                "cycle": cycle, "pos": pos, "points": points,
                "values": values, "hypers": np.array(model._hypers),
                "noises": np.array(model._noises),
                "alpha": states.K_inv_y.detach().cpu().numpy(),
                "held_points": states.points_sampled[0].detach().cpu()
                .numpy(),
                "held_values": np.array(model._data.points_sampled_value),
                "walkers_before": walkers_before, "chain_pos": chain_pos,
                "chain_lp": chain_lp,
                "picks": np.asarray(picks, dtype=float),
                "recommended": np.asarray(rec, dtype=float)})
        return it

    def window(self, seconds: float, on_cycle=None) -> float:
        """Cycles until ``seconds`` have passed; ``on_cycle(cycle, start)``
        is called before and after each cycle (``start`` True, then False;
        the profiler's start and stop), off the window's clock.  Returns
        the window's length."""
        clock = 0.0
        cycle = 0
        while clock < seconds:
            t0 = time.perf_counter()
            if cycle:
                with self.spans.span("restore", {}):
                    self.restore()
            if on_cycle:
                clock += time.perf_counter() - t0
                on_cycle(cycle, True)
                t0 = time.perf_counter()
            for pos in range(self.per_cycle):
                if pos and clock + time.perf_counter() - t0 >= seconds:
                    break
                self.iterations.append(self.iteration(cycle, pos))
            clock += time.perf_counter() - t0
            if on_cycle:
                on_cycle(cycle, False)
            cycle += 1
        return clock

    def close(self) -> None:
        """Free the driver's programs and state, put the port's chain
        functions back and remove the saved state."""
        from cornell_moe_tpu_torch.models import mcmc
        for name, fn in self._wrapped.items():
            setattr(mcmc, name, fn)
        self._chain = None
        self.bo.program_cache.release()
        self.bo = None
        for name in os.listdir(self._dir):
            os.remove(os.path.join(self._dir, name))
        os.rmdir(self._dir)
