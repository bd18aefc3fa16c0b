"""Tokenizers for the text endpoints of the HTTP service (port of
flexq_tpu/serve/tokenizer.py, the same ids).

  - ``ByteTokenizer``: UTF-8 bytes, no files (ids 3..258 are the bytes;
    0 / 1 / 2 are pad / bos / eos, matching the serve default eos_id=2);
  - ``HFTokenizer``: a local ``transformers`` tokenizer directory, never
    downloaded (``transformers`` is imported inside, and only there);
  - ``apply_chat_template``: the tokenizer's template where it has one,
    else a generic role-tagged format.

``load_tokenizer(None | "byte")`` gives a ByteTokenizer, ``load_tokenizer(
path)`` an HFTokenizer.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: byte b <-> id 3 + b.

    Vocab layout: 0=pad, 1=bos, 2=eos, 3..258 = the 256 byte values.
    Any model with vocab_size >= 259 can be driven through it (quality of
    byte-level generation depends on the model, but the id mapping is total:
    every string round-trips exactly).
    """

    pad_id = 0
    bos_id = 1
    eos_id = 2
    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [3 + b for b in text.encode("utf-8")]
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - 3 for i in ids if 3 <= int(i) < 259)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: Sequence[dict]) -> str:
        return _generic_chat_template(messages)


class HFTokenizer:
    """Adapter over a local HuggingFace tokenizer directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.eos_id = int(self.tok.eos_token_id)
        self.bos_id = (
            int(self.tok.bos_token_id) if self.tok.bos_token_id is not None else None
        )

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self.tok.encode(text, add_special_tokens=False)
        # chat templates usually embed the BOS token in the text (it
        # re-encodes to bos_id even with add_special_tokens=False) —
        # prepending again would double the BOS and degrade generation
        if add_bos and self.bos_id is not None and (
            not ids or ids[0] != self.bos_id
        ):
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(ids), skip_special_tokens=True)

    def apply_chat_template(self, messages: Sequence[dict]) -> str:
        if getattr(self.tok, "chat_template", None):
            return self.tok.apply_chat_template(
                list(messages), tokenize=False, add_generation_prompt=True
            )
        return _generic_chat_template(messages)


def _generic_chat_template(messages: Sequence[dict]) -> str:
    """Minimal role-tagged template for tokenizers without one."""
    parts = []
    for m in messages:
        parts.append(f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


def load_tokenizer(spec: Optional[str]):
    """None or "byte" -> ByteTokenizer; anything else -> local HF directory."""
    if spec is None or spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)
