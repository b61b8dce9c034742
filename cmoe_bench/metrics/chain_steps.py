"""Mean stretch-move steps of the retrain chains in the window
(``model.last_chain_steps`` after each ``observe()``)."""

LAYER = "model"
UNIT = "steps"
SOURCE = "program_counter"
MOVES = "iter_s"


def read(run):
    vals = [it["chain_steps"] for it in run.iterations]
    return sum(vals) / len(vals) if vals else None
