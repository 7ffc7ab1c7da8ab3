"""Peak device memory over set-up and window, read by the benchmark from the
CUDA caching allocator on the host, torch.cuda.max_memory_allocated
(GB = 1e9 bytes)."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 1e9
