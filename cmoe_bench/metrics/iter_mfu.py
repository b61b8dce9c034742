"""The least time of the window's counted work over the iterations' summed
wall time: every chain's log-marginal-likelihood evaluations
(``roofline.lml_bound``) and every ensemble fit's K + noise
(``roofline.covariance_bound``), over the observed channels, each at the
largest of its pipes, so
that the share cannot pass 100%.  KG's descent and the recommendation's
grid are not counted yet."""

from cmoe_bench import roofline

LAYER = "iteration"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "iter_s"


def read(run):
    wall = sum(it["seconds"] for it in run.iterations)
    if not run.on_card or wall <= 0:
        return None
    kernel, dtype = run.cfg["kernel_name"], run.cfg["dtype"]
    channels = 1 + len(run.cfg.get("observations", []))
    least = sum(
        roofline.lml_bound(it["walkers"] * (it["chain_steps"] + 1),
                           it["padded_n"], run.dim, kernel, dtype,
                           channels)["ms"] +
        it["fits"] * roofline.covariance_bound(
            it["ensemble"], it["padded_n"], run.dim, kernel, dtype,
            channels)["ms"]
        for it in run.iterations) * 1e-3
    return 100.0 * least / wall
