"""The train step's share of the card's float32 peak (%): the model FLOPs
of the traced steps (forward and backward, no recomputation counted) at
67 TFLOP/s, over the slice's wall time."""


def read(run):
    if not run["wall_s"]:
        return None
    need = run["steps"] * run["step_flops"] / run["peaks"]["f32_flops_per_s"]
    return 100.0 * need / run["wall_s"]
