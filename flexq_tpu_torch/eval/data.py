"""Evaluation and calibration data loaders (port of flexq_tpu/eval/data.py).

Every loader reads a ``datasets.save_to_disk`` directory and imports
``datasets`` inside the function (without it, an ImportError names the
package); the tokenizer is any callable with the HF interface
(``tokenizer(text, return_tensors="np").input_ids``). The joins, the window
slicing and the ``np.random.default_rng`` draws are the reference's: the
test perplexity text is joined with "\n\n", encoded in one pass and sliced
into seqlen windows.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

# the reference checkout's wikitext-2 copy, relative to the working directory
DEFAULT_WIKITEXT2 = "datasets/wikitext-2-raw-v1"


def _load_from_disk(path: str):
    try:
        from datasets import load_from_disk
    except ImportError as e:
        raise ImportError("reading a datasets.save_to_disk directory needs the `datasets` package") from e
    return load_from_disk(path)


def dataset_available(path: str = DEFAULT_WIKITEXT2, split: str = "test") -> bool:
    """True if the arrow shard is real data (not a git-LFS pointer stub)."""
    shard = os.path.join(path, split, "data-00000-of-00001.arrow")
    try:
        with open(shard, "rb") as f:
            head = f.read(64)
    except OSError:
        return False
    return not head.startswith(b"version https://git-lfs")


def load_wikitext2_text(path: str = DEFAULT_WIKITEXT2, split: str = "test") -> str:
    """Returns the raw joined text of a wikitext-2 split."""
    if not dataset_available(path, split):
        raise FileNotFoundError(
            f"{path}/{split} holds git-LFS pointer stubs, not data; provide a "
            "real wikitext-2 dataset directory (datasets.save_to_disk format)"
        )
    ds = _load_from_disk(path)
    return "\n\n".join(ds[split]["text"])


def tokenize_eval_ids(text: str, tokenizer, seqlen: int = 2048) -> np.ndarray:
    """Encode the full text and slice into [n, seqlen] windows
    (reference main.py:96-101: testenc.input_ids sliced per 2048)."""
    ids = tokenizer(text, return_tensors="np").input_ids[0]
    n = len(ids) // seqlen
    return ids[: n * seqlen].reshape(n, seqlen).astype(np.int32)


JOINERS = {"wikitext2": "\n\n", "ptb": " ", "c4": "\n\n", "pile": "\n\n"}
TEXT_FIELDS = {"wikitext2": "text", "ptb": "sentence", "c4": "text", "pile": "text"}


def load_eval_text(
    name: str, path: str, split: str = "test"
) -> str:
    """Generic offline loader for the reference's eval sets
    (datautils.py get_wikitext2/get_ptb/get_c4/get_pile join conventions).

    ``path`` is a datasets.save_to_disk directory.
    """
    if not dataset_available(path, split):
        raise FileNotFoundError(f"{path}/{split}: no real data (LFS stub or missing)")
    ds = _load_from_disk(path)
    if hasattr(ds, "keys") and split in ds.keys():
        ds = ds[split]
    field = TEXT_FIELDS.get(name, "text")
    return JOINERS.get(name, "\n\n").join(ds[field])


def calib_samples(
    text: str, tokenizer, nsamples: int = 128, seqlen: int = 2048, seed: int = 0
) -> np.ndarray:
    """Random seqlen windows for calibration (datautils.py train loaders)."""
    rng = np.random.default_rng(seed)
    ids = tokenizer(text, return_tensors="np").input_ids[0]
    starts = rng.integers(0, len(ids) - seqlen - 1, nsamples)
    return np.stack([ids[s : s + seqlen] for s in starts]).astype(np.int32)


def load_eval_docs(name: str, path: str, split: str = "validation") -> List[str]:
    """Document-level loader (for the c4-style per-document protocols)."""
    if not dataset_available(path, split):
        raise FileNotFoundError(f"{path}/{split}: no real data (LFS stub or missing)")
    ds = _load_from_disk(path)
    if hasattr(ds, "keys") and split in ds.keys():
        ds = ds[split]
    field = TEXT_FIELDS.get(name, "text")
    return list(ds[field])


def c4_eval_ids(
    docs: List[str], tokenizer, seqlen: int = 2048, nwindows: int = 256, seed: int = 0
) -> np.ndarray:
    """C4 perplexity protocol (reference datautils.py get_c4:96-109): draw
    `nwindows` random documents that tokenize to >= seqlen tokens and take a
    random seqlen window from each. Returns [nwindows, seqlen] int32."""
    rng = np.random.default_rng(seed)
    out = []
    tries = 0
    while len(out) < nwindows:
        tries += 1
        if tries > 100 * nwindows:
            raise ValueError("not enough documents of >= seqlen tokens")
        i = int(rng.integers(0, len(docs)))
        ids = tokenizer(docs[i], return_tensors="np").input_ids[0]
        if len(ids) < seqlen:
            continue
        if len(ids) == seqlen:
            out.append(ids)
        else:
            s = int(rng.integers(0, len(ids) - seqlen))
            out.append(ids[s : s + seqlen])
    return np.stack(out).astype(np.int32)


def doc_calib_samples(
    docs: List[str], tokenizer, nsamples: int = 128, seqlen: int = 2048, seed: int = 0
) -> np.ndarray:
    """C4-style calibration: random seqlen windows from random long docs
    (reference get_c4 trainloader construction)."""
    rng = np.random.default_rng(seed)
    out = []
    tries = 0
    while len(out) < nsamples:
        tries += 1
        if tries > 100 * nsamples:
            raise ValueError("not enough documents of >= seqlen tokens")
        i = int(rng.integers(0, len(docs)))
        ids = tokenizer(docs[i], return_tensors="np").input_ids[0]
        if len(ids) <= seqlen:
            continue
        s = int(rng.integers(0, len(ids) - seqlen - 1))
        out.append(ids[s : s + seqlen])
    return np.stack(out).astype(np.int32)
