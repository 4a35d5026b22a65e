"""Peak device memory (GiB): ``torch.cuda.max_memory_allocated`` from process
start to the window's end, so that work moved into set-up shows."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2**30
