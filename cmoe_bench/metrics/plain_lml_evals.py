"""The plain log marginal likelihood's evaluations per traced iteration:
the growth of the port's counter ``model.lml_plain`` (one per
hyperparameter set of a batch, wherever ``models/likelihood.py``'s plain
LML runs; a program replays the growth its capture counted) inside the
port's spans ``driver.observe``, over the traced iterations.  A retrain's
chain evaluates W walkers at its start and W per stretch-move step, so a
sound retrain reads W (steps + 1) and what its fit evaluates besides.
Nothing where the port keeps no record of its spans or no such counter."""

LAYER = "model"
UNIT = "evals"
SOURCE = "program_counter"
MOVES = "iter_s"
COUNTER = "model.lml_plain"
SPAN = "driver.observe"


def growth(run):
    """The counter's growth in each ``driver.observe`` record of the
    traced cycle, in order; None where the port keeps no records, or the
    counter grew in none of them."""
    if not run.traced:
        return None
    try:
        from cornell_moe_tpu_torch.utils import logging_utils
    except ImportError:
        return None
    records = getattr(logging_utils, "records", None)
    if records is None:
        return None
    grew = [r["counters"].get(COUNTER, 0) for r in records()
            if r["name"] == SPAN]
    return grew if any(grew) else None


def read(run):
    grew = growth(run)
    return None if grew is None else sum(grew) / len(run.traced)
