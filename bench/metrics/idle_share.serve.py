"""Share of the traced slice's wall time in which no operation ran on the
card (%), in a serving cell."""


def read(run):
    wall = run["wall_s"]
    return 100.0 * (1.0 - run["profile"]["busy_s"] / wall) if wall else None
