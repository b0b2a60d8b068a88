"""The whole serving step's share of the card's peak (%): the work of the
real tokens of every model call in the traced slice, each part at its own
peak (resident int8 products and attention at the int8 rate, the float32
lm head and experts at the float32 rate), over the slice's wall time.
Pad rows and idle slots count for nothing."""


def read(run):
    pk = run["peaks"]
    calls = run.get("calls", [])
    if not calls or not run["wall_s"]:
        return None
    need = sum((w["int8_ops"] + w["attn_ops"]) / pk["int8_ops_per_s"]
               + w["f32_flops"] / pk["f32_flops_per_s"] for w in calls)
    return 100.0 * need / run["wall_s"]
