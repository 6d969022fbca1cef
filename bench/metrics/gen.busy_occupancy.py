"""gen.busy_occupancy: the engine's busy occupancy (slots doing a decode
step or a prefill chunk per device round) over the window's batches,
weighted by their rounds, as a share of the wave, in %."""


def read(run):
    busy = sum(u["slot_steps"] for u in run.units)
    slots = sum(u["decode_steps"] * u["wave"] for u in run.units)
    return 100.0 * busy / slots
