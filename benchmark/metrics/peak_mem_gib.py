"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and window,
after reset_peak_memory_stats() at the start of the run, in GiB."""


def read(run):
    return run.peak_bytes / 2.0 ** 30
