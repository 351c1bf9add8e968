"""Kernel a (``csrc/topk_kernels.cu``: the bf16 score pass
``cosine_scores`` and the select that follows it) against its bound: each
call's bound (the corpus rows and their validity read once, the query read,
k pairs written; 2 x rows x d operations) over the device time of its
kernels, from the profiler's trace. The select kernels it shares with
kernel c are a's when they follow a select over score rows (``RowKeys``)."""

from bench_cells.roofline import bound_s, score_pass_work


def a_seconds(kernels) -> tuple[int, float]:
    calls, secs, owner = 0, 0.0, None
    for name, s in kernels:
        if "cosine_scores<false>" in name:
            calls += 1
            secs += s
            owner = "a"
        elif "select_hist" in name or "select_collect" in name:
            owner = "a" if "RowKeys" in name else "c"
            secs += s if owner == "a" else 0.0
        elif "select_sort" in name or "select_rank" in name:
            secs += s if owner == "a" else 0.0
    return calls, secs


def read(trace: dict):
    if "corpus_rows" not in trace:
        return None
    calls, secs = a_seconds(trace["kernels"])
    if not calls or secs <= 0:
        return None
    nbytes, ops = score_pass_work(trace["corpus_rows"], trace["dims"]["hidden"], 1,
                                  trace["top_k"])
    return 100.0 * calls * bound_s(nbytes, ops) / secs
