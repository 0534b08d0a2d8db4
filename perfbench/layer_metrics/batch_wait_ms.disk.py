"""batch_wait_ms.disk: the mean host time a window step spends in next()
on the system's feed, clocked by the task."""


def read(ctx):
    waits = ctx["task"].batch_wait_s
    return 1e3 * sum(waits) / len(waits) if waits else None
