"""The chain's log-marginal-likelihood evaluations against the device
time of the retrains, in the traced cycle: the least time of every
walker's evaluation (``roofline.lml_bound`` at the padded n, d and the
observed channels; W walkers per stretch-move step and W for the chain's
start) over the device-busy seconds inside the ``observe`` spans.  Both
sides come from the chain's work and the model's shapes, not from a
kernel's name, so the share reads the same work whatever evaluates it."""

from cmoe_bench import roofline

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "iter_s"


def read(run):
    if run.trace is None or not run.traced:
        return None
    busy = run.trace.busy_in_spans("observe")
    if busy <= 0:
        return None
    channels = 1 + len(run.cfg.get("observations", []))
    least = sum(roofline.lml_bound(
        it["walkers"] * (it["chain_steps"] + 1), it["padded_n"], run.dim,
        run.cfg["kernel_name"], run.cfg["dtype"], channels)["ms"]
        for it in run.traced) * 1e-3
    return 100.0 * least / busy
