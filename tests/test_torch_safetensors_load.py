"""The port's checkpoint reader, ``codesearch_tpu_torch.models.encoder
.read_safetensors``: one read of a safetensors file's data section as raw
bytes onto the target device, each tensor a view of it, every transpose and
cast done there. Held against the JAX package's host path (numpy, f32,
transposed on the host) and torch's own casts, with the synthetic
checkpoints of ``tests/test_safetensors_load.py``.

- Every buffer and parameter of a ``BertEncoder`` built from bert, nomic
  and ModernBERT files in F32, F16 and BF16 equals, bit for bit, the one
  the host path gives, for inference and training.
- The ``bert.``/``model.``/``encoder.`` prefixes, unaligned offsets, reads
  that come back short, a missing tensor, bad files, the span's counts, the
  cross-encoder's head and the service's load inside the index call's open.
- On the card (``cuda``): the pinned ring in steps smaller than the file,
  and a read that fails partway waits for the copies it queued.
"""

import dataclasses
import io

import numpy as np
import pytest
import test_safetensors_load as tsl
from test_safetensors_load import (
    CFG,
    MB_CFG,
    NOMIC_CFG,
    _synthetic_hf_bert,
    _synthetic_modernbert,
    _synthetic_nomic,
)

from codesearch_tpu.models.registry import ArchConfig

PORT_FAMILIES = {"bert": (CFG, _synthetic_hf_bert), "nomic": (NOMIC_CFG, _synthetic_nomic),
                 "modernbert": (MB_CFG, _synthetic_modernbert)}
PORT_DTYPES = {"F32": "float32", "F16": "float16", "BF16": "bfloat16"}


def _port_checkpoint(tmp_path, family: str, dtype: str, prefix: str = ""):
    """(checkpoint in ``dtype``, the same values widened to an f32
    checkpoint, cfg) of a synthetic ``family`` checkpoint."""
    import torch
    from safetensors.torch import load_file, save_file

    cfg, write = PORT_FAMILIES[family]
    st = tmp_path / "model.safetensors"
    write(st, prefix) if family == "bert" else write(st, cfg)
    tensors = {k: v.to(getattr(torch, PORT_DTYPES[dtype])) for k, v in load_file(st).items()}
    save_file(tensors, str(st))
    wide = tmp_path / "wide.safetensors"
    save_file({k: v.float() for k, v in tensors.items()}, str(wide))
    return st, wide, cfg


def _expected_state(tree: dict, cfg, trainable: bool) -> dict:
    """A ``BertEncoder``'s buffers or parameters by hand from a numpy tree:
    ``emb_*`` and norms f32, BERT's q, k and v fused, dense layer leaves
    (``*_w``, ``*_b``) cast from f32 to bf16 by torch unless trainable."""
    import torch

    flat = {f"emb_{k}": v for k, v in tree["embeddings"].items()}
    if "final_ln_scale" in tree:
        flat["final_ln_scale"] = tree["final_ln_scale"]
    for i, layer in enumerate(tree["layers"]):
        layer = dict(layer)
        if cfg.arch_style == "bert":
            layer["qkv_w"] = np.concatenate([layer.pop(x + "_w") for x in "qkv"], axis=1)
            layer["qkv_b"] = np.concatenate([layer.pop(x + "_b") for x in "qkv"])
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    out = {}
    for name, v in flat.items():
        t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
        dense = name.startswith("layers.") and name.endswith(("_w", "_b"))
        out[name] = t if trainable or not dense else t.to(torch.bfloat16)
    return out


def _assert_state_bits(enc, want: dict) -> None:
    """Every buffer and parameter of ``enc`` equals ``want`` bit for bit, in
    its own contiguous memory (none holds the checkpoint's bytes alive)."""
    import torch

    got = {**dict(enc.named_buffers()), **dict(enc.named_parameters())}
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = want[name]
        assert t.dtype == w.dtype and t.shape == w.shape, name
        assert t.is_contiguous(), name
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), name
        ints = torch.int16 if t.element_size() == 2 else torch.int32
        assert torch.equal(t.detach().view(ints), w.view(ints)), name


def _jax_reference(wide, cfg) -> dict:
    """The JAX package's tree of the f32 checkpoint, as f32 numpy."""
    from codesearch_tpu.models.encoder import load_safetensors
    from codesearch_tpu_torch.models import encoder as te

    return te.params_from_jax(load_safetensors(wide, cfg))


@pytest.mark.parametrize("trainable", [False, True], ids=["inference", "trainable"])
@pytest.mark.parametrize("dtype", list(PORT_DTYPES))
@pytest.mark.parametrize("family", list(PORT_FAMILIES))
def test_port_reader_builds_the_host_paths_encoder(tmp_path, family, dtype, trainable):
    from codesearch_tpu_torch.models import encoder as te

    st, wide, cfg = _port_checkpoint(tmp_path, family, dtype)
    enc = te.BertEncoder(cfg, te.load_safetensors(st, cfg, "cpu"), device="cpu",
                         trainable=trainable)
    _assert_state_bits(enc, _expected_state(_jax_reference(wide, cfg), cfg, trainable))


@pytest.mark.parametrize("prefix", ["", "bert.", "model.", "encoder."])
def test_port_reader_finds_prefixed_names(tmp_path, prefix):
    from codesearch_tpu_torch.models import encoder as te

    st, wide, cfg = _port_checkpoint(tmp_path, "bert", "F16", prefix)
    tree = te.load_safetensors(st, cfg, "cpu")
    assert len(tree["layers"]) == cfg.layers
    enc = te.BertEncoder(cfg, tree, device="cpu")
    _assert_state_bits(enc, _expected_state(_jax_reference(wide, cfg), cfg, False))


_HEADER_DTYPES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16", "uint8": "U8"}


def _write_unaligned(path, tensors: dict, lead: int) -> None:
    """A safetensors file written by hand, a ``lead``-byte U8 tensor first,
    so every later tensor's offset is ``lead`` bytes off its alignment."""
    import json

    import torch

    header, data, at = {}, [], 0
    for name, t in [("lead", torch.arange(lead, dtype=torch.uint8)), *tensors.items()]:
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _HEADER_DTYPES[str(t.dtype).split(".")[1]],
                        "shape": list(t.shape), "data_offsets": [at, at + len(raw)]}
        data.append(raw)
        at += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.write_bytes(len(head).to_bytes(8, "little") + head + b"".join(data))


@pytest.mark.parametrize("lead", [1, 3])
@pytest.mark.parametrize("dtype", ["F32", "BF16"])
def test_port_reader_copies_unaligned_tensors(tmp_path, dtype, lead):
    import torch
    from safetensors.torch import load_file

    from codesearch_tpu_torch.models import encoder as te

    st, wide, cfg = _port_checkpoint(tmp_path, "nomic", dtype)
    odd = tmp_path / "odd.safetensors"
    _write_unaligned(odd, load_file(st), lead)
    got = te.read_safetensors(odd, "cpu")
    want = load_file(st)
    assert sorted(got) == sorted(["lead", *want])
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    enc = te.BertEncoder(cfg, te.load_safetensors(odd, cfg, "cpu"), device="cpu")
    _assert_state_bits(enc, _expected_state(_jax_reference(wide, cfg), cfg, False))


def _short_reads(monkeypatch, te, step: int) -> None:
    """The reader's file gives at most ``step`` bytes a read."""
    class Short(io.FileIO):
        def readinto(self, b):
            return super().readinto(memoryview(b)[:step])

    monkeypatch.setattr(te, "open", lambda path, mode, buffering: Short(path, mode),
                        raising=False)


@pytest.mark.parametrize("step", [64, 100, 1 << 20])
def test_port_reader_steps_through_a_file_larger_than_a_step(tmp_path, monkeypatch, step):
    import torch
    from safetensors.torch import load_file

    from codesearch_tpu_torch.models import encoder as te

    st, _wide, _cfg = _port_checkpoint(tmp_path, "modernbert", "F16")
    _short_reads(monkeypatch, te, step)
    got = te.read_safetensors(st, "cpu")
    want = load_file(st)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_port_reader_missing_tensor_raises(tmp_path):
    from codesearch_tpu_torch.models import encoder as te

    st, _wide, cfg = _port_checkpoint(tmp_path, "modernbert", "BF16")
    with pytest.raises(KeyError, match="missing tensor"):
        te.load_safetensors(st, dataclasses.replace(cfg, layers=cfg.layers + 1), "cpu")


def test_port_reader_refuses_a_bad_file(tmp_path):
    from codesearch_tpu_torch.models import encoder as te

    st, _wide, _cfg = _port_checkpoint(tmp_path, "nomic", "F32")
    whole = st.read_bytes()
    cut = tmp_path / "cut.safetensors"
    cut.write_bytes(whole[:-5])
    with pytest.raises(ValueError, match="outside the data section"):
        te.read_safetensors(cut, "cpu")
    head_len = int.from_bytes(whole[:8], "little")
    odd = tmp_path / "f8.safetensors"
    odd.write_bytes(whole[:8] + whole[8:8 + head_len].replace(b'"F32"', b'"U64"', 1)
                    + whole[8 + head_len:])
    with pytest.raises(ValueError, match="dtype U64"):
        te.read_safetensors(odd, "cpu")
    huge = tmp_path / "huge.safetensors"
    huge.write_bytes((len(whole) - 7).to_bytes(8, "little") + whole[8:])
    with pytest.raises(ValueError, match="does not fit the file"):
        te.read_safetensors(huge, "cpu")


def test_port_reader_span_counts_bytes_and_tensors(tmp_path):
    from codesearch_tpu_torch.models import encoder as te
    from codesearch_tpu_torch.utils import tracing

    st, _wide, cfg = _port_checkpoint(tmp_path, "bert", "BF16")
    head_len = int.from_bytes(st.read_bytes()[:8], "little")
    tracing.reset()
    with tracing.recording():
        tensors = te.read_safetensors(st, "cpu")
    load = tracing.snapshot()["spans"]["cs.model.load"]
    tracing.reset()
    assert load["count"] == 1
    assert load["counts"] == {"bytes": st.stat().st_size - 8 - head_len,
                              "tensors": len(tensors)}


def test_port_cross_encoder_head_from_the_reader(tmp_path, monkeypatch):
    import torch
    from safetensors.torch import load_file, save_file

    from codesearch_tpu_torch.models import cross_encoder as ce

    tiny = ArchConfig(vocab_size=200, hidden=32, layers=1, heads=2, intermediate=64,
                      max_len=64, pooling="cls")
    model_dir = tmp_path / "jina-reranker-v1-turbo-en"
    model_dir.mkdir()
    st = model_dir / "model.safetensors"
    monkeypatch.setattr(tsl, "CFG", tiny)
    _synthetic_hf_bert(st, prefix="bert.")
    g = torch.Generator().manual_seed(3)
    tensors = {**load_file(st),
               "bert.pooler.dense.weight": torch.randn(32, 32, generator=g),
               "bert.pooler.dense.bias": torch.randn(32, generator=g),
               "classifier.weight": torch.randn(1, 32, generator=g),
               "classifier.bias": torch.randn(1, generator=g)}
    save_file({k: v.half() for k, v in tensors.items()}, str(st))
    monkeypatch.setattr(ce, "CROSS_ENCODER_ARCH", tiny)
    model = ce.CrossEncoder(tmp_path, device="cpu")
    assert model.pretrained
    for ours, theirs in (("pooler_w", "bert.pooler.dense.weight"),
                         ("pooler_b", "bert.pooler.dense.bias"),
                         ("cls_w", "classifier.weight"), ("cls_b", "classifier.bias")):
        t = model._head[ours]
        assert t.dtype == torch.float32
        assert torch.equal(t, tensors[theirs].half().float()), ours
        assert t.untyped_storage().nbytes() == t.numel() * 4, ours
    scores = model.score_pairs("find parser", ["def parse(): ...", "class Draw: ..."])
    assert scores.shape == (2,) and ((scores > 0) & (scores < 1)).all()


def test_port_service_loads_inside_the_index_open(tmp_path):
    """The embedding service reads its checkpoint through the reader: one
    ``cs.model.load`` span, a child of the span open around the service's
    construction (``cs.index.open`` in ``index()``)."""
    from codesearch_tpu.models.registry import MODELS

    from codesearch_tpu_torch.embed.service import _BertBackend
    from codesearch_tpu_torch.utils import tracing

    spec = dataclasses.replace(MODELS["nomic-v1"], arch=NOMIC_CFG, dims=NOMIC_CFG.hidden)
    model_dir = tmp_path / "models" / spec.short_name
    model_dir.mkdir(parents=True)
    _synthetic_nomic(model_dir / "model.safetensors")
    tracing.reset()
    with tracing.recording(), tracing.span("cs.index.open"):
        backend = _BertBackend(spec, tmp_path / "models", device="cpu")
    spans = {s.name: s for s in tracing.spans()}
    tracing.reset()
    assert spans["cs.model.load"].parent == spans["cs.index.open"].id
    assert spans["cs.model.load"].counts["tensors"] == 4 + 9 * NOMIC_CFG.layers
    out = backend.embed(["def rotary(x): return x"])
    assert out.shape == (1, NOMIC_CFG.hidden) and np.isfinite(out).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("step", [64, 100, 1 << 20])
def test_port_reader_on_cuda_steps_through_the_ring(cuda, tmp_path, monkeypatch, step):
    import torch
    from safetensors.torch import load_file

    from codesearch_tpu_torch.models import encoder as te

    st, _wide, _cfg = _port_checkpoint(tmp_path, "modernbert", "F16")
    monkeypatch.setattr(te, "STAGE_BYTES", step)
    monkeypatch.setattr(te, "_RING", [])
    got = te.read_safetensors(st, cuda)
    want = load_file(st)
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].device.type == "cuda" and torch.equal(got[k].cpu(), t), k


@pytest.mark.cuda
def test_port_reader_on_cuda_waits_for_its_copies_when_a_read_fails(cuda, tmp_path,
                                                                    monkeypatch):
    """The file shrinks during the read: the reader raises only once the
    copies it queued (behind a sleep on the stream) have finished, and
    gives the ring back."""
    import os

    import torch
    from safetensors.torch import load_file

    from codesearch_tpu_torch.models import encoder as te

    st, _wide, _cfg = _port_checkpoint(tmp_path, "modernbert", "F16")
    step = 4096
    head_len = int.from_bytes(st.read_bytes()[:8], "little")
    monkeypatch.setattr(te, "STAGE_BYTES", step)
    monkeypatch.setattr(te, "STAGE_SLOTS", 8)
    monkeypatch.setattr(te, "_RING", [])
    real, calls = te._read_into, []

    def read_into(f, view):
        calls.append(view.nbytes)
        if len(calls) == 5:      # the header's two reads, then the data's third step
            os.truncate(st, 8 + head_len + 3 * step + 100)
        real(f, view)

    monkeypatch.setattr(te, "_read_into", read_into)
    whole = st.read_bytes()
    assert len(whole) > 8 + head_len + 5 * step
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e8))      # about a quarter second ahead of the copies
    with pytest.raises(ValueError, match="ends inside its data section"):
        te.read_safetensors(st, cuda)
    assert torch.cuda.current_stream().query()
    assert not te._RING_LOCK.locked()
    st.write_bytes(whole)
    got = te.read_safetensors(st, cuda)
    want = load_file(st)
    assert all(torch.equal(got[k].cpu(), t) for k, t in want.items())
