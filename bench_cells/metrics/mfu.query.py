"""The whole query's least device time over the window, as a share: for
every query of the window, the encoder's forward over its real tokens, the
exact score pass over the corpus and the postings its BM25 terms select,
each at the larger of its operations over the bf16 peak and its bytes over
the memory rate, summed, over the window's length. Counts come from the
benchmark's own inputs (frozen tokenizer, reference statistics)."""

from bench_cells.roofline import HBM_BYTES_PER_S, bound_s, encoder_flops, score_pass_work


def read(trace: dict):
    if "query_tokens" not in trace or not trace.get("window_s"):
        return None
    dims = trace["dims"]
    sb, so = score_pass_work(trace["corpus_rows"], dims["hidden"], 1, trace["top_k"])
    least = 0.0
    for n, post in zip(trace["query_tokens"], trace["posting_bytes"]):
        least += bound_s(trace["weight_bytes"], encoder_flops(dims, [n]))
        least += bound_s(sb, so) + post / HBM_BYTES_PER_S
    return 100.0 * least / trace["window_s"]
