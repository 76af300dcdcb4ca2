"""The scheduler's wall ms a decode step inside its fused windows:
Δ `phase_seconds["window"]` over the window ÷ the steps those windows ran
(Δ `fused_windows_run` × the window length; a captured window always runs
all its steps)."""


def read(run, name):
    d = run.delta
    if not d.get("windows") or d.get("window_s") is None:
        return None
    return 1e3 * d["window_s"] / (d["windows"] * run.cfg["fuse_window"])
