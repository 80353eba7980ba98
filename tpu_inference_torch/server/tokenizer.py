"""Tokenizer adapters (twin of ``tpu_inference/server/tokenizer.py``).

- ``ByteTokenizer``: hermetic UTF-8 byte-level tokenizer (vocab 256
  bytes + BOS/EOS). No files, no network.
- ``HFTokenizer``: a local HuggingFace tokenizer directory (Llama,
  Mixtral, GPT-2 vocabularies) through ``transformers.AutoTokenizer``
  with ``local_files_only``; never the network.
- ``IncrementalDecoder``: token ids -> text deltas for streaming.
- ``StopMatcher``: Ollama ``options.stop`` across chunk boundaries.
"""

from __future__ import annotations

import sys
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


class HFTokenizer:
    """Local HuggingFace tokenizer directory (no network)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_token_id is not None:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: List[dict]) -> Optional[str]:
        """Chat messages rendered with the checkpoint's own chat template
        (tokenizer_config.json), or None when it has none or the
        template fails to render (the caller then falls back to a
        role-prefix transcript). A leading BOS text is stripped: encode()
        prepends the BOS id itself."""
        if not getattr(self._tok, "chat_template", None):
            return None
        try:
            rendered = self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        # Templates raise jinja2 errors of their own (e.g. on roles that
        # do not alternate) besides the standard ones.
        except Exception as e:  # noqa: BLE001
            print(f"[tokenizer] chat template failed ({e!r}); falling "
                  "back to role-prefix transcript", file=sys.stderr)
            return None
        bos = self._tok.bos_token
        if bos and rendered.startswith(bos):
            rendered = rendered[len(bos):]
        return rendered


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
    """'byte' -> ByteTokenizer; anything else is a local HF tokenizer
    directory."""
    if spec == "byte":
        return ByteTokenizer(vocab_size=max(vocab_size, 258))
    return HFTokenizer(spec)
