"""Data-parallel embedding over the device mesh (port of
``codesearch_tpu/parallel/dp_embed.py``).

A batch pads to a multiple of the shard count and splits into one block of
rows a shard, each embedded on its shard's device; the results come back to
the host together. The model (the hash table or the encoder) is copied once
to each distinct device of the mesh, not once a shard: ``replicate`` makes
the copies, and callers that embed many batches keep them and pass the
mapping in place of the model.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.encoder import BertEncoder
from ..models.hash_embedder import embed_features
from ..utils.device import to_host


def replicate(model, mesh) -> dict:
    """``{device: copy}`` of a table tensor or a ``BertEncoder`` for every
    distinct device of the mesh; on the model's own device the copy is the
    model itself."""
    def on(dev):
        if isinstance(model, torch.Tensor):
            return model.to(dev)
        return model if model.device == dev else BertEncoder(model.cfg, model.to_params(),
                                                              device=dev)

    return {dev: on(dev) for dev in mesh.distinct}


def _shard_rows(arr: np.ndarray, mesh, fill) -> list[torch.Tensor]:
    """``arr``'s rows padded with ``fill`` to a multiple of the shard count,
    one block a shard, each on its shard's device."""
    s = mesh.shape["data"]
    pad = (-arr.shape[0]) % s
    if pad:
        arr = np.concatenate([arr, np.full((pad, *arr.shape[1:]), fill, arr.dtype)])
    per = arr.shape[0] // s
    return [torch.from_numpy(np.ascontiguousarray(arr[i * per:(i + 1) * per])).to(dev)
            for i, dev in enumerate(mesh.shard_devices)]


def embed_feature_shards(table, ids: np.ndarray, weights: np.ndarray,
                         mesh) -> list[torch.Tensor]:
    """The hash-model embed of each shard's rows, launched and left on the
    shards' devices (``dp_embed_features`` without the read back)."""
    tables = table if isinstance(table, dict) else replicate(table, mesh)
    return [embed_features(tables[dev], i, w) for dev, i, w in
            zip(mesh.shard_devices, _shard_rows(ids, mesh, 0), _shard_rows(weights, mesh, 0))]


def dp_embed_features(table, ids: np.ndarray, weights: np.ndarray, mesh,
                      half_transfer: bool = False) -> np.ndarray:
    """Hash-model embed with the batch sharded over mesh axis "data" ->
    [n, d] f32 on the host. ``table`` is the table or ``replicate``'s
    mapping. ``half_transfer`` rounds to fp16 on the device before the copy
    (bulk indexing keeps fp16 rows anyway)."""
    outs = embed_feature_shards(table, ids, weights, mesh)
    if half_transfer:
        outs = [o.half() for o in outs]
    return np.concatenate(to_host(*outs)).astype(np.float32)[:ids.shape[0]]


def encode_shards(encoder, input_ids: np.ndarray, attention_mask: np.ndarray,
                  mesh) -> list[torch.Tensor]:
    """The encoder forward of each shard's rows, left on the shards'
    devices (``dp_encode`` without the read back). Padding rows have a mask
    of ones, as the JAX package pads them."""
    encoders = encoder if isinstance(encoder, dict) else replicate(encoder, mesh)
    return [encoders[dev].encode(i, m) for dev, i, m in
            zip(mesh.shard_devices, _shard_rows(input_ids, mesh, 0),
                _shard_rows(attention_mask, mesh, 1))]


def dp_encode(encoder, input_ids: np.ndarray, attention_mask: np.ndarray, mesh) -> np.ndarray:
    """BERT-family encode with the batch sharded over mesh axis "data" ->
    [n, hidden] f32 on the host (``encoder`` is the port's ``BertEncoder``,
    or ``replicate``'s mapping, in place of the JAX function's params and
    cfg)."""
    outs = encode_shards(encoder, input_ids, attention_mask, mesh)
    return np.concatenate(to_host(*outs))[:input_ids.shape[0]]
