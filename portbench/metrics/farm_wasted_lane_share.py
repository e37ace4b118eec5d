"""Share of the farm's lane steps spent on lanes with nothing to do
(``FarmEngine.stats``: wasted_lane_steps / lane_steps), over the window and
its drain, in percent."""


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("lane_steps"):
        return None
    return 100.0 * s["wasted_lane_steps"] / s["lane_steps"]
