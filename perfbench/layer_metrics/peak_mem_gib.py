"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in GiB."""


def read(ctx):
    peak = ctx["window"]["peak_bytes"]
    return peak / 2 ** 30 if peak else None
