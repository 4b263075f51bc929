"""bases_per_s: the bases of every call of the window over the window's
length (first call's start to last call's end)."""


def read(w):
    total = sum(work.get("bases", 0) for _, work in w.calls)
    return total / w.window_s if total and w.window_s > 0 else None
