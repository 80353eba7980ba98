"""Tokenizer adapters (twin of ``tpu_inference/server/tokenizer.py``).

- ``ByteTokenizer``: hermetic UTF-8 byte-level tokenizer (vocab 256
  bytes + BOS/EOS). No files, no network.
- ``IncrementalDecoder``: token ids -> text deltas for streaming.
- ``StopMatcher``: Ollama ``options.stop`` across chunk boundaries.

Local HuggingFace tokenizers are ROADMAP item 1.9.
"""

from __future__ import annotations

from typing import List, Optional, Protocol


class Tokenizer(Protocol):
    vocab_size: int
    bos_token_id: Optional[int]
    eos_token_id: Optional[int]

    def encode(self, text: str, add_bos: bool = True) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes as tokens; ids 0-255 = bytes, 256 = BOS, 257 = EOS."""

    def __init__(self, vocab_size: int = 512):
        assert vocab_size >= 258
        self.vocab_size = vocab_size
        self.bos_token_id = 256
        self.eos_token_id = 257

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class IncrementalDecoder:
    """Streams token ids -> text chunks. One instance per request.

    Decoding each token independently is wrong for non-concatenative
    tokenizers (SentencePiece/Metaspace pieces like "▁the" decode to
    "the" alone but " the" in context), so this keeps a sliding window:
    re-decode from the previous emit point and yield only the text
    delta (the vLLM detokenizer offset scheme). The window resets on
    every emit, so per-token cost stays O(tokens since last emit).
    A trailing replacement char means an incomplete UTF-8/byte-fallback
    sequence — hold until a later token completes it.

    ``prompt_tail``: the last few prompt ids, seeding the window so the
    first generated piece keeps its inter-word spacing after the prompt.
    """

    def __init__(self, tokenizer: Tokenizer, prompt_tail: List[int] = ()):
        self._tok = tokenizer
        self._ids: List[int] = list(prompt_tail)
        self._prefix = 0                   # window start
        self._read = len(self._ids)        # already-emitted boundary

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        prefix_text = self._tok.decode(self._ids[self._prefix:self._read])
        full_text = self._tok.decode(self._ids[self._prefix:])
        if full_text.endswith("�") or len(full_text) <= len(prefix_text):
            return ""
        self._prefix = self._read
        self._read = len(self._ids)
        return full_text[len(prefix_text):]

    def flush(self) -> str:
        prefix_text = self._tok.decode(self._ids[self._prefix:self._read])
        full_text = self._tok.decode(self._ids[self._prefix:])
        self._read = len(self._ids)
        return full_text[len(prefix_text):]


class StopMatcher:
    """Scans a text stream for stop sequences spanning chunk boundaries.

    ``push(chunk)`` returns (text safe to emit, stopped). Text that could
    be the prefix of a stop string is held back until disambiguated, so a
    stop sequence split across streamed tokens is still caught and the
    stop string itself is never emitted (Ollama ``options.stop``).
    """

    def __init__(self, stops: List[str]):
        self.stops = [s for s in stops if s]
        self._buf = ""

    def push(self, text: str) -> tuple:
        if not self.stops:
            return text, False
        self._buf += text
        cut = min((i for i in (self._buf.find(s) for s in self.stops)
                   if i >= 0), default=-1)
        if cut >= 0:
            out, self._buf = self._buf[:cut], ""
            return out, True
        hold = 0
        for s in self.stops:
            for n in range(min(len(s) - 1, len(self._buf)), hold, -1):
                if self._buf.endswith(s[:n]):
                    hold = n
                    break
        out = self._buf[:len(self._buf) - hold]
        self._buf = self._buf[len(self._buf) - hold:]
        return out, False

    def flush(self) -> str:
        out, self._buf = self._buf, ""
        return out


def build_tokenizer(spec: str, vocab_size: int = 512) -> Tokenizer:
    """'byte' -> ByteTokenizer."""
    if spec == "byte":
        return ByteTokenizer(vocab_size=max(vocab_size, 258))
    raise NotImplementedError(
        f"tokenizer {spec!r}: HF tokenizers are not ported yet (ROADMAP "
        "1.9: HF tokenizer and checkpoint loading); use 'byte'")
