"""Kernel d (``csrc/attention_kernels.cu`` ``attention_two_sweep``) against
its bound over the indexing window: the attention's bytes and operations
for the real tokens of every embedded chunk at every full layer, the layers
kernel d runs (a windowed layer takes another route; each byte read or
written once, valid keys only), at the larger of bytes over the memory rate
and operations over the bf16 peak, over the device time of the kernel's
launches from the profiler's trace."""

from bench_cells.roofline import attention_work, bound_s


def read(trace: dict):
    if "text_tokens" not in trace:
        return None
    secs = sum(s for name, s in trace["kernels"] if "attention_two_sweep" in name)
    if secs <= 0:
        return None
    nbytes, ops = attention_work(trace["dims"], trace["text_tokens"], windowed=False)
    return 100.0 * bound_s(nbytes, ops) / secs
