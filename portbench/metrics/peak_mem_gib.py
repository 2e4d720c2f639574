"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the run up to the
window's close (set-up included), in GiB."""


def read(rec):
    if not rec.peak_bytes:
        return None
    return rec.peak_bytes / 2 ** 30
