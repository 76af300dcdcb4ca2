"""Host ms for one step's call to return with the card idle before it (no
sync inside the call): the executor's cost to enqueue a step, the mean of
the calls the runner timed (`enqueue_s`)."""


def read(run, name):
    s = getattr(run, "enqueue_s", None)
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
