"""The encoder's model operations over the indexing window, against the
bf16 peak: 2 per matrix-product weight a real token plus the attention over
the valid keys inside each layer's window, for every chunk the window's
index calls embedded (real tokens counted by the frozen tokenizer from the
stored chunks' texts)."""

from bench_cells.roofline import PEAK_OPS_PER_S, encoder_flops


def read(trace: dict):
    if "text_tokens" not in trace or not trace.get("window_s"):
        return None
    flops = encoder_flops(trace["dims"], trace["text_tokens"])
    return 100.0 * flops / trace["window_s"] / PEAK_OPS_PER_S["bf16"]
