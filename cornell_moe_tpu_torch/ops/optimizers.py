"""Multistart gradient ascent with the reference GD loop's semantics, a
backtracking line-search ascent, and damped Newton.

Counterpart of ``cornell_moe_tpu/ops/optimizers.py``: decaying step size
``pre_mult * (i+1)^(-gamma)`` (reset each restart round), steps clamped by
``domain.limit_update``, Polyak averaging of the trailing
``num_steps_averaged`` steps, and an optional step-norm convergence gate.
``lax.scan`` becomes a Python loop; the gated loops read their condition
on the host once per step (``.item()``).  The objective is MAXIMIZED.
Every GD step taken counts one ``optimizers.gd_steps``
(``utils.logging_utils.count``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from cornell_moe_tpu_torch.utils import logging_utils


@dataclasses.dataclass(frozen=True)
class GradientDescentParameters:
    num_multistarts: int = 40
    max_num_steps: int = 100
    max_num_restarts: int = 2
    num_steps_averaged: int = 0
    gamma: float = 0.7
    pre_mult: float = 1.0
    max_relative_change: float = 1.0
    tolerance: float = 1.0e-7


@dataclasses.dataclass(frozen=True)
class NewtonParameters:
    num_multistarts: int = 8
    max_num_steps: int = 100
    gamma: float = 1.05
    time_factor: float = 1.0e-2
    max_relative_change: float = 1.0
    tolerance: float = 1.0e-9


class MultistartResult(NamedTuple):
    best_point: torch.Tensor
    best_value: torch.Tensor
    all_points: torch.Tensor
    all_values: torch.Tensor


def _finite(g: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(g), g, 0.0)


def ascent_step(domain, max_relative_change: float, x: torch.Tensor,
                g: torch.Tensor, rate):
    """(x_new, dx): one step of ``rate`` (a float or a 0-d tensor) along
    the ascent direction g (non-finite entries zeroed), limited by the
    domain."""
    dx = domain.limit_update(max_relative_change, x, rate * _finite(g))
    return x + dx, dx


def _trailing_window_mean(buf: list, rows: int, width: int) -> torch.Tensor:
    """Mean of a circular trajectory buffer, summed oldest first (the
    order of ``mean(traj[-width:])`` on the fixed-depth path)."""
    ordered = [buf[(rows + k) % width] for k in range(width)]
    return torch.mean(torch.stack(ordered), dim=0)


class _Schedule:
    """The shared GD step and averaging rules of one parameter pack."""

    def __init__(self, params: GradientDescentParameters, domain):
        self.params = params
        self.domain = domain
        self.avg_n = max(int(params.num_steps_averaged), 0)
        self.num_steps = int(params.max_num_steps)
        self.use_avg = 0 < self.avg_n <= self.num_steps
        self.num_rounds = max(int(params.max_num_restarts), 1)
        self.width = max(self.avg_n, 1)
        self.min_rows = self.width if self.use_avg else 1
        self.steps_taken = 0      # steps taken by :meth:`_take`, in all

    def rate(self, i) -> float:
        """The step size at step index i."""
        p = self.params
        return p.pre_mult * (i + 1.0) ** (-p.gamma)

    def step(self, x, g, i):
        """(x_new, dx) for ascent direction g at step index i."""
        return ascent_step(self.domain, self.params.max_relative_change, x,
                           g, self.rate(i))

    def average(self, traj: list) -> torch.Tensor:
        return self.domain.clip(torch.mean(
            torch.stack(traj[-self.avg_n:]), dim=0))

    def _take(self, grad_fn, step_fn, x, i):
        """(x_new, dx) at step index i: :meth:`step` along ``grad_fn(x)``,
        or ``step_fn(x, rate)`` (one step's program) when given."""
        self.steps_taken += 1
        logging_utils.count("optimizers.gd_steps")
        if step_fn is None:
            return self.step(x, grad_fn(x), i)
        return step_fn(x, self.rate(i))

    def round(self, grad_fn, x, start_i: int, first_row=None,
              step_fn=None):
        """One fixed-depth restart round; returns the round's endpoint."""
        traj = [] if first_row is None else [first_row]
        for i in range(start_i, self.num_steps):
            x, _ = self._take(grad_fn, step_fn, x, i)
            traj.append(x)
        return self.average(traj) if self.use_avg else x

    def round_gated(self, grad_fn, x, conv_tol: float, start_i: int,
                    first_row=None, batch_axes=None, step_fn=None):
        """One restart round with the step-norm early exit; returns the
        round's endpoint.  ``batch_axes`` None: one point, else the max step
        norm over the batch gates."""
        buf = [x] * self.width
        rows = 0
        if first_row is not None:
            buf[0] = first_row
            rows = 1
        i = start_i
        norm = float("inf")
        while i < self.num_steps and (norm >= conv_tol or
                                      rows < self.min_rows):
            x, dx = self._take(grad_fn, step_fn, x, i)
            buf[rows % self.width] = x
            rows += 1
            if batch_axes is None:
                norm = torch.sqrt(torch.sum(dx * dx)).item()
            else:
                norm = torch.max(torch.sqrt(
                    torch.sum(dx * dx, dim=batch_axes))).item()
            i += 1
        if self.use_avg:
            x = self.domain.clip(_trailing_window_mean(buf, rows,
                                                       self.width))
        return x


def _ascend(value_and_grad_fn: Callable, domain, x0: torch.Tensor,
            params: GradientDescentParameters, conv_tol: Optional[float],
            batch_axes, step_fn: Optional[Callable] = None) -> torch.Tensor:
    sch = _Schedule(params, domain)

    def grad_fn(x):
        return value_and_grad_fn(x)[1]

    x = x0
    for _ in range(sch.num_rounds):
        if conv_tol is None:
            x = sch.round(grad_fn, x, 0, step_fn=step_fn)
        else:
            x = sch.round_gated(grad_fn, x, conv_tol, 0,
                                batch_axes=batch_axes, step_fn=step_fn)
    return x


def gradient_ascent(value_and_grad_fn: Callable, domain, x0: torch.Tensor,
                    params: GradientDescentParameters,
                    conv_tol: Optional[float] = None,
                    step_fn: Optional[Callable] = None) -> torch.Tensor:
    """One restarted GD trajectory from x0; returns the final point.
    ``step_fn(x, rate) -> (x_new, dx)``, when given, takes each step
    (:func:`ascent_step` along the gradient at x: a program of one step,
    the recommendation's) in place of ``value_and_grad_fn``."""
    return _ascend(value_and_grad_fn, domain, x0, params, conv_tol, None,
                   step_fn)


def gradient_ascent_line_search(value_and_grad_fn: Callable, domain,
                                x0: torch.Tensor,
                                params: GradientDescentParameters,
                                max_backtracks: int = 8,
                                shrink: float = 0.5) -> torch.Tensor:
    """Backtracking line-search gradient ascent: propose the domain-limited
    ``alpha_i * grad``, shrink it while the objective does not improve.
    The backtrack budget is fixed: all ``max_backtracks`` trials run, the
    first accepted step is kept, and a step with no acceptance leaves x
    where it is."""
    v, _ = value_and_grad_fn(x0)
    x = x0
    for i in range(int(params.max_num_steps)):
        _, g = value_and_grad_fn(x)
        alpha = params.pre_mult * (i + 1.0) ** (-params.gamma)
        dx = domain.limit_update(params.max_relative_change, x,
                                 alpha * _finite(g))
        accepted = torch.zeros((), dtype=torch.bool, device=x.device)
        for _ in range(max_backtracks):
            v_try, _ = value_and_grad_fn(x + dx)
            ok = v_try > v
            dx = torch.where(ok & ~accepted, dx,
                             dx * torch.where(accepted, 1.0, shrink))
            accepted = accepted | ok
        x = torch.where(accepted, x + dx, x)
        v, _ = value_and_grad_fn(x)
    return x


def gradient_ascent_batch(batched_value_and_grad: Callable, domain,
                          x0: torch.Tensor,
                          params: GradientDescentParameters,
                          conv_tol: Optional[float] = None,
                          step_fn: Optional[Callable] = None
                          ) -> torch.Tensor:
    """Restarted GD on a whole batch of starts at once; ``conv_tol`` gates
    on the max step norm over the batch; ``step_fn`` as in
    :func:`gradient_ascent`."""
    return _ascend(batched_value_and_grad, domain, x0, params, conv_tol,
                   tuple(range(1, x0.dim())), step_fn)


def _chunked_multistart(run_batch: Callable, value_fn: Callable,
                        initial_points: torch.Tensor,
                        chunk_size: Optional[int]) -> MultistartResult:
    """Run restarts (whole or in sequential chunks), score the endpoints,
    argmax-select (non-finite values lose)."""
    n = initial_points.shape[0]
    if chunk_size and n % chunk_size == 0 and n > chunk_size:
        finals, values = [], []
        for chunk in initial_points.split(chunk_size):
            f = run_batch(chunk)
            finals.append(f)
            values.append(value_fn(f))
        final_points, values = torch.cat(finals), torch.cat(values)
    else:
        final_points = run_batch(initial_points)
        values = value_fn(final_points)
    return select_best(final_points, values)


def select_best(final_points: torch.Tensor, values: torch.Tensor
                ) -> MultistartResult:
    """The argmax over every start's endpoint (non-finite values lose)."""
    safe = torch.where(torch.isfinite(values), values, float("-inf"))
    best = int(torch.argmax(safe))
    return MultistartResult(best_point=final_points[best],
                            best_value=values[best],
                            all_points=final_points, all_values=values)


def multistart_optimize_batched(batched_value_and_grad: Callable, domain,
                                initial_points: torch.Tensor,
                                params: GradientDescentParameters,
                                chunk_size: Optional[int] = None,
                                conv_tol: Optional[float] = None,
                                step_fn: Optional[Callable] = None
                                ) -> MultistartResult:
    """Multistart GD with a batched objective (see gradient_ascent_batch);
    ``step_fn(x, rate) -> (x_new, dx)`` takes the GD steps of every chunk
    when given (the endpoints are scored by the objective)."""
    def run_batch(starts):
        return gradient_ascent_batch(batched_value_and_grad, domain, starts,
                                     params, conv_tol=conv_tol,
                                     step_fn=step_fn)

    return _chunked_multistart(run_batch,
                               lambda c: batched_value_and_grad(c)[0],
                               initial_points, chunk_size)


def multistart_optimize_batched_warm(bvg_cold: Callable, bvg_warm: Callable,
                                     domain, initial_points: torch.Tensor,
                                     params: GradientDescentParameters,
                                     chunk_size: Optional[int] = None,
                                     conv_tol: Optional[float] = None,
                                     warm_step: Optional[Callable] = None,
                                     return_stats: bool = False
                                     ) -> MultistartResult:
    """Multistart GD threading an inner-problem carry across outer steps.

    ``bvg_cold(x) -> (values, grads, carry)`` initializes the carry at the
    start of each chunk and scores the endpoints; ``bvg_warm(x, carry) ->
    (values, grads, carry)`` drives every later step, or, when given,
    ``warm_step(x, carry, rate) -> (x_new, dx, carry)`` takes each of those
    steps whole (one step's program).  The first step of the first round
    consumes the cold gradients, and that point is row 0 of the round's
    trajectory.  ``conv_tol`` ends a chunk's round once every point's step
    norm is below it, never before the Polyak window is full.

    ``return_stats``: the result is (MultistartResult, evaluations), the
    warm steps each chunk took (int32, (n_chunks,) when the starts were
    chunked, else 0-d), counted on the host by the step loop, which
    already reads the gate there.
    """
    sch = _Schedule(params, domain)
    axes = tuple(range(1, initial_points.dim()))
    evaluations = []

    def run_batch(starts):
        taken = sch.steps_taken
        x = run_chunk(starts)
        evaluations.append(sch.steps_taken - taken)
        return x

    def run_chunk(starts):
        if sch.num_steps == 0:
            return starts
        _, g0, carry = bvg_cold(starts)
        x, _ = sch.step(starts, g0, 0)
        state = {"carry": carry}

        def grad_fn(xx):
            _, g, state["carry"] = bvg_warm(xx, state["carry"])
            return g

        step_fn = None
        if warm_step is not None:
            def step_fn(xx, rate):
                xx, dx, state["carry"] = warm_step(xx, state["carry"], rate)
                return xx, dx

        for rnd in range(sch.num_rounds):
            first = rnd == 0
            start_i = 1 if first else 0
            first_row = x if first else None
            if conv_tol is None:
                x = sch.round(grad_fn, x, start_i, first_row, step_fn)
            else:
                x = sch.round_gated(grad_fn, x, conv_tol, start_i,
                                    first_row, batch_axes=axes,
                                    step_fn=step_fn)
        return x

    result = _chunked_multistart(run_batch, lambda c: bvg_cold(c)[0],
                                 initial_points, chunk_size)
    if not return_stats:
        return result
    evals = torch.tensor(evaluations, dtype=torch.int32)
    return result, evals if len(evaluations) > 1 else evals[0]


def multistart_optimize(value_and_grad_fn: Callable, domain,
                        initial_points: torch.Tensor,
                        params: GradientDescentParameters,
                        value_fn: Optional[Callable] = None,
                        chunk_size: Optional[int] = None,
                        conv_tol: Optional[float] = None
                        ) -> MultistartResult:
    """Per-start multistart GD (each start its own trajectory and gate)
    with argmax reduction."""
    if value_fn is None:
        def value_fn(x):
            return value_and_grad_fn(x)[0]

    def run_batch(starts):
        return torch.stack([gradient_ascent(value_and_grad_fn, domain, x0,
                                            params, conv_tol=conv_tol)
                            for x0 in starts])

    return _chunked_multistart(
        run_batch, lambda c: torch.stack([value_fn(x) for x in c]),
        initial_points, chunk_size)


def multistart_optimize_with_dumb_search_fallback(
        value_and_grad_fn: Callable, domain, initial_points: torch.Tensor,
        search_points: torch.Tensor, params: GradientDescentParameters,
        value_fn: Optional[Callable] = None) -> MultistartResult:
    """Per-start multistart GD, then the best of a brute-force evaluation
    at ``search_points`` where it beats the GD's best (non-finite values
    lose).  ``all_points`` and ``all_values`` are the GD's."""
    if value_fn is None:
        def value_fn(x):
            return value_and_grad_fn(x)[0]

    gd = multistart_optimize(value_and_grad_fn, domain, initial_points,
                             params, value_fn)
    search_values = torch.stack([value_fn(x) for x in search_points])
    safe = torch.where(torch.isfinite(search_values), search_values,
                       float("-inf"))
    best_search = torch.argmax(safe)
    take_search = safe[best_search] > gd.best_value
    return MultistartResult(
        best_point=torch.where(take_search, search_points[best_search],
                               gd.best_point),
        best_value=torch.where(take_search, safe[best_search],
                               gd.best_value),
        all_points=gd.all_points, all_values=gd.all_values)


def value_and_grad(value_fn: Callable) -> Callable:
    """x -> (value_fn(x), its gradient) by ``torch.func.grad_and_value``
    (the gradient bit for bit ``torch.func.grad``'s), the counterpart of
    ``jax.value_and_grad``."""
    grad_and_value = torch.func.grad_and_value(value_fn)

    def vg(x):
        g, v = grad_and_value(x)
        return v, g
    return vg


def newton_optimize(value_and_grad_fn: Callable, domain, x0: torch.Tensor,
                    params: NewtonParameters,
                    hessian_fn: Optional[Callable] = None) -> torch.Tensor:
    """Damped Newton ascent over points (D,) of ``value_and_grad_fn(x) ->
    (value, gradient)``, the JAX package's contract.  The Hessian is
    ``hessian_fn(x)``, or when None ``torch.func.hessian`` of the value
    part, which must then be differentiable by ``torch.func`` (as
    :func:`value_and_grad`'s is).  Step i solves (-H + I / (time_factor
    gamma^(i+1))) dx = g, the damping fading as the steps go on; a
    non-finite step becomes 0, and the domain limits it."""
    if hessian_fn is None:
        hessian_fn = torch.func.hessian(lambda x: value_and_grad_fn(x)[0])
    eye = torch.eye(x0.shape[-1], dtype=x0.dtype, device=x0.device)
    x = x0
    for i in range(int(params.max_num_steps)):
        _, g = value_and_grad_fn(x)
        damp = 1.0 / (params.time_factor * params.gamma ** (i + 1.0))
        dx, _ = torch.linalg.solve_ex(-hessian_fn(x) + damp * eye, g)
        dx = _finite(dx)
        x = x + domain.limit_update(params.max_relative_change, x, dx)
    return x
