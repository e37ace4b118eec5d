"""Share of the engine's slot steps burned on retired or done-masked slots
(``ContinuousEngine.stats``: idle_slot_steps / slot_steps), over the window
and its drain, in percent."""


def read(ctx):
    s = ctx.get("stats", {})
    if not s.get("slot_steps"):
        return None
    return 100.0 * s["idle_slot_steps"] / s["slot_steps"]
