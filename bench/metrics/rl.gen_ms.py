"""rl.gen_ms: the mean GEN task (actor generation) per iteration of the
window, from the engine's measured Event timeline."""
import statistics


def read(run):
    return 1e3 * statistics.fmean(u["tasks"]["actor_generation"]
                                  for u in run.units)
