"""peak_mem_GiB: the allocator's peak over the window
(``torch.cuda.max_memory_allocated``, reset after set-up), in GiB."""


def read(run):
    return None if run.peak_window_bytes is None else run.peak_window_bytes / 2**30
