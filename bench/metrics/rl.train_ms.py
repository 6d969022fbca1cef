"""rl.train_ms: the mean TRAIN task (the actor's PPO-clip step with Adam)
per iteration of the window, from the engine's measured Event timeline
(each task's span ends when the card has finished its work)."""
import statistics


def read(run):
    return 1e3 * statistics.fmean(u["tasks"]["actor_training"]
                                  for u in run.units)
