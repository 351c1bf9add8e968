"""The windowed kernel (``csrc/attention_kernels.cu``
``attention_window_band``) against its bound over the indexing window: the
attention's bytes and operations for the real tokens of every embedded
chunk at every windowed layer, the layers it runs (each byte read or
written once; the valid keys inside each valid query row's window), at the
larger of bytes over the memory rate and operations over the bf16 peak,
over the device time of the kernel's launches from the profiler's trace. A
program without the kernel reads None."""

from bench_cells.roofline import attention_work, bound_s


def read(trace: dict):
    if "text_tokens" not in trace:
        return None
    secs = sum(s for name, s in trace["kernels"] if "attention_window_band" in name)
    if secs <= 0:
        return None
    nbytes, ops = attention_work(trace["dims"], trace["text_tokens"], windowed=True)
    return 100.0 * bound_s(nbytes, ops) / secs
