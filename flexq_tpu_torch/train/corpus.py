"""In-environment text corpus + tokenizer for the tiny-model accuracy gate
(port of flexq_tpu/train/corpus.py).

A small LLaMA-shape model is trained from scratch on text that exists on
the machine (package docs, library sources, licenses), and the
fp-vs-quantized perplexity flow runs on it. Corpus construction is
deterministic: a fixed walk order, content-hash dedup, a fixed-seed
document shuffle and a split by source unit, so every run of
``build_corpus`` over the same roots writes byte-identical splits, the
reference's.

``encode_file`` is the port's own byte-level BPE encoder over a
``tokenizers`` ``tokenizer.json`` (the GPT-2 pre-tokenizer, the merges, the
added tokens), so encoding needs neither ``tokenizers`` nor ``regex``; it
gives the ids ``tokenizers`` gives. Only ``train_tokenizer`` imports
``tokenizers``.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import re
import sys
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# Document separator: a blank-line paragraph break keeps the stream natural
# for an LM while still giving the splitter clean document boundaries.
DOC_SEP = "\n\n"

_TEXT_EXT = (".md", ".rst", ".txt")
_CODE_EXT = (".py",)
_SKIP_DIR_PARTS = (
    "/tests/", "/test/", "/__pycache__/", "/.git/", "/node_modules/",
    "/locale/", "/locales/",
)
_SKIP_NAMES = ("changelog", "requirements", "entry_points", "record", "authors")


def _printable_ratio(s: str) -> float:
    if not s:
        return 0.0
    good = sum(1 for c in s if c.isprintable() or c in "\n\t ")
    return good / len(s)


def _read_doc(path: str, max_bytes: int = 4 << 20) -> str | None:
    try:
        if os.path.getsize(path) > max_bytes:
            return None
        with open(path, "rb") as f:
            raw = f.read()
        text = raw.decode("utf-8")
    except (OSError, UnicodeDecodeError):
        return None
    if len(text) < 512:
        return None
    if _printable_ratio(text[:8192]) < 0.97:
        return None
    return text


def iter_corpus_files(roots: Sequence[str], include_code: bool = True) -> Iterable[str]:
    exts = _TEXT_EXT + (_CODE_EXT if include_code else ())
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            full = dirpath + "/"
            if any(part in full for part in _SKIP_DIR_PARTS):
                continue
            for name in sorted(filenames):
                low = name.lower()
                if not low.endswith(exts):
                    continue
                if any(s in low for s in _SKIP_NAMES):
                    continue
                yield os.path.join(dirpath, name)


def _unit_key(path: str, roots: Sequence[str]) -> str:
    """Source unit a file belongs to: the top-level package/dir under its
    root. The train/val/test split is by UNIT, not document: package docs
    are full of near-duplicates (licenses, vendored copies, boilerplate
    headers) that a document-level split leaks across the boundary."""
    for root in roots:
        if path.startswith(root):
            rel = path[len(root) :].lstrip("/")
            top = rel.split("/", 1)[0]
            return f"{os.path.basename(root)}/{top}"
    return "misc"


def default_roots() -> List[str]:
    """numpy's site-packages and the system's docs and licenses (the
    reference's roots but its own sources)."""
    site = os.path.dirname(os.path.dirname(np.__file__))
    return [site, "/usr/share/doc", "/usr/share/common-licenses"]


def build_corpus(
    out_dir: str,
    roots: Sequence[str] | None = None,
    max_mb: int = 64,
    heldout_mb: float = 1.0,
    seed: int = 0,
    exclude_units: Sequence[str] = (),
) -> dict:
    """Walk ``roots``, dedup, split by source unit, write train/val/test .txt.

    Val and test each get whole held-out units totalling ~``heldout_mb`` MB;
    everything else is train. ``exclude_units`` (unit keys as
    ``_unit_key`` forms them, e.g. another corpus's held-out units) are
    skipped before their files are read, so none of their documents reaches
    any split; the manifest then lists them. Returns a manifest dict (also
    written to ``out_dir/MANIFEST.txt``)."""
    if roots is None:
        roots = default_roots()

    os.makedirs(out_dir, exist_ok=True)
    excluded = set(exclude_units)
    by_unit: dict = {}
    seen = set()
    total = 0
    budget = max_mb << 20
    for path in iter_corpus_files(roots):
        if excluded and _unit_key(path, roots) in excluded:
            continue
        text = _read_doc(path)
        if text is None:
            continue
        digest = hashlib.sha256(text.encode("utf-8")).digest()
        if digest in seen:
            continue
        seen.add(digest)
        by_unit.setdefault(_unit_key(path, roots), []).append(text)
        total += len(text)
        if total >= budget:
            break

    # candidate held-out units: moderate size, not globally-duplicated
    # license text (common-licenses reappears verbatim inside every package)
    unit_bytes = {u: sum(len(d) for d in docs) for u, docs in by_unit.items()}
    candidates = sorted(
        u
        for u, b in unit_bytes.items()
        if 32_768 <= b <= 2 << 20 and "licenses" not in u and "doc/" not in u
    )
    rng = random.Random(seed)
    rng.shuffle(candidates)
    target = int(heldout_mb * (1 << 20))
    held: dict = {"val": [], "test": []}
    sizes = {"val": 0, "test": 0}
    for u in candidates:
        name = "val" if sizes["val"] <= sizes["test"] else "test"
        if sizes["val"] >= target and sizes["test"] >= target:
            break
        held[name].append(u)
        sizes[name] += unit_bytes[u]

    splits = {"val": [], "test": [], "train": []}
    for u, docs in sorted(by_unit.items()):
        if u in held["val"]:
            splits["val"].extend(docs)
        elif u in held["test"]:
            splits["test"].extend(docs)
        else:
            splits["train"].extend(docs)
    rng.shuffle(splits["train"])
    manifest = {
        "n_docs": sum(len(d) for d in by_unit.values()),
        "bytes": total,
        "seed": seed,
        "roots": list(roots),
        "val_units": sorted(held["val"]),
        "test_units": sorted(held["test"]),
    }
    if excluded:
        manifest["excluded_units"] = sorted(excluded)
    for name, part in splits.items():
        p = os.path.join(out_dir, f"{name}.txt")
        with open(p, "w", encoding="utf-8") as f:
            f.write(DOC_SEP.join(part))
        manifest[f"{name}_docs"] = len(part)
        manifest[f"{name}_bytes"] = os.path.getsize(p)
    with open(os.path.join(out_dir, "MANIFEST.txt"), "w", encoding="utf-8") as f:
        for k, v in manifest.items():
            f.write(f"{k}: {v}\n")
    return manifest


def read_manifest_units(manifest_path: str) -> List[str]:
    """The val and test units a ``MANIFEST.txt`` holds out."""
    units: List[str] = []
    with open(manifest_path, encoding="utf-8") as f:
        for line in f:
            key, _, value = line.partition(": ")
            if key in ("val_units", "test_units"):
                units += re.findall(r"'([^']*)'", value)
    return units


def train_tokenizer(corpus_dir: str, vocab_size: int = 8192) -> str:
    """Byte-level BPE on train.txt -> ``corpus_dir/tokenizer.json``.

    Byte-level means no OOV; vocab_size is a multiple of 128 so the packed
    vocab GEMM (quantized lm_head) needs no padding."""
    from tokenizers import ByteLevelBPETokenizer

    tok = ByteLevelBPETokenizer()
    tok.train(
        [os.path.join(corpus_dir, "train.txt")],
        vocab_size=vocab_size,
        min_frequency=2,
        special_tokens=["<pad>", "<s>", "</s>"],
    )
    out = os.path.join(corpus_dir, "tokenizer.json")
    tok.save(out)
    return out


# ------------------------------------------------- the byte-level BPE encoder


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table (the ByteLevel alphabet)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _char_classes(preds) -> List[str]:
    """For each predicate on a general category, a ``re`` character class
    body of every code point whose category it takes, as ranges."""
    parts: List[List[str]] = [[] for _ in preds]
    starts: List[int | None] = [None] * len(preds)
    for cp in range(sys.maxunicode + 2):
        cat = unicodedata.category(chr(cp)) if cp <= sys.maxunicode else ""
        for i, pred in enumerate(preds):
            inside = cat != "" and pred(cp, cat)
            if inside and starts[i] is None:
                starts[i] = cp
            elif not inside and starts[i] is not None:
                lo, hi = re.escape(chr(starts[i])), re.escape(chr(cp - 1))
                parts[i].append(lo if starts[i] == cp - 1 else f"{lo}-{hi}")
                starts[i] = None
    return ["".join(p) for p in parts]


def _gpt2_pattern() -> "re.Pattern[str]":
    """The ByteLevel pre-tokenizer's GPT-2 pattern,
    ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``,
    in stdlib ``re``: ``\\p{L}`` / ``\\p{N}`` as explicit classes of the
    Unicode general categories L* / N* (``[^\\W\\d_]`` would also take ``²``,
    ``½`` and Roman numerals as letters), and ``\\s`` as Oniguruma's Unicode
    whitespace (\\t-\\r, U+0085 and the Z[slp] categories; Python's ``\\s``
    also takes \\x1c-\\x1f). The categories are those of the interpreter's
    ``unicodedata`` (Unicode 15.0 in Python 3.12): a code point assigned
    later (Unicode 15.1 / 16.0 scripts) is unassigned here, where
    ``tokenizers`` may class it as a letter."""
    letters, numbers, space = _char_classes((
        lambda cp, cat: cat[0] == "L",
        lambda cp, cat: cat[0] == "N",
        lambda cp, cat: 0x09 <= cp <= 0x0D or cp == 0x85 or cat in ("Zs", "Zl", "Zp"),
    ))
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+| ?[^{space}{letters}{numbers}]+"
        rf"|[{space}]+(?![^{space}])|[{space}]+"
    )


class ByteLevelBPE:
    """Encoder of a ``tokenizers`` byte-level BPE ``tokenizer.json``: the
    added tokens split out first, the GPT-2 pre-tokenizer, each piece's
    UTF-8 bytes mapped to the ByteLevel alphabet and merged by rank (the
    lowest-ranked adjacent pair first, every occurrence left to right),
    each distinct piece merged once (a word cache)."""

    def __init__(self, tokenizer_path: str):
        with open(tokenizer_path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        pre = spec.get("pre_tokenizer") or {}
        if model.get("type") != "BPE" or pre.get("type") != "ByteLevel" or spec.get("normalizer") is not None:
            raise ValueError(f"{tokenizer_path}: not a byte-level BPE tokenizer without a normalizer")
        if pre.get("add_prefix_space") or not pre.get("use_regex", True):
            raise ValueError(f"{tokenizer_path}: only the ByteLevel pre-tokenizer without a prefix space is encoded")
        self.vocab: Dict[str, int] = model["vocab"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in model["merges"]]
        self.ranks: Dict[Tuple[str, str], int] = {pair: i for i, pair in enumerate(merges)}
        self.added = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        # leftmost-longest, as tokenizers' added-vocabulary matcher
        names = sorted(self.added, key=len, reverse=True)
        self.added_re = re.compile("|".join(map(re.escape, names))) if names else None
        self.byte_map = _bytes_to_unicode()
        self.pattern = _gpt2_pattern()
        self.cache: Dict[str, List[int]] = {}

    def _bpe(self, piece: str) -> List[int]:
        word = [self.byte_map[b] for b in piece.encode("utf-8")]
        ranks = self.ranks
        while len(word) > 1:
            best = min(zip(word, word[1:]), key=lambda p: ranks.get(p, len(ranks)))
            if best not in ranks:
                break
            a, b = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        return [self.vocab[t] for t in word]

    def _encode_plain(self, text: str, out: List[int]) -> None:
        cache = self.cache
        for piece in self.pattern.findall(text):
            ids = cache.get(piece)
            if ids is None:
                ids = cache[piece] = self._bpe(piece)
            out.extend(ids)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        pos = 0
        if self.added_re is not None:
            for m in self.added_re.finditer(text):
                self._encode_plain(text[pos : m.start()], out)
                out.append(self.added[m.group()])
                pos = m.end()
        self._encode_plain(text[pos:], out)
        return out


def encode_file(tokenizer_path: str, text_path: str, out_npy: str) -> int:
    """Tokenize a split to a flat uint16 token stream (vocab < 65536), in
    1 Mi-character chunks as the reference does; the ids ``tokenizers``
    gives."""
    tok = ByteLevelBPE(tokenizer_path)
    with open(text_path, encoding="utf-8") as f:
        text = f.read()
    ids: List[int] = []
    step = 1 << 20
    for i in range(0, len(text), step):
        ids.extend(tok.encode(text[i : i + step]))
    arr = np.asarray(ids, dtype=np.uint16)
    np.save(out_npy, arr)
    return int(arr.size)
