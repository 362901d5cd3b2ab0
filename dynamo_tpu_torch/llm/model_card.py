"""Model Deployment Card (MDC): serializable model identity.

Captures what a frontend/preprocessor needs to serve a model (tokenizer,
chat template, context length, special tokens) plus a content checksum.
Counterpart of the JAX package's ``llm/model_card.py`` for local HF-layout
directories and single ``.gguf`` files; the checksum is computed the same
way, so both packages give a model directory the same ``mdcsum``.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ModelDeploymentCard:
    display_name: str
    model_path: Optional[str] = None
    context_length: int = 4096
    tokenizer_file: Optional[str] = None  # path to tokenizer.json (HF fast format)
    chat_template: Optional[str] = None
    bos_token: Optional[str] = None
    eos_token: Optional[str] = None
    eos_token_ids: list[int] = field(default_factory=list)
    model_config: dict[str, Any] = field(default_factory=dict)
    mdcsum: Optional[str] = None
    gguf_path: Optional[str] = None  # set when the model came from a .gguf

    @classmethod
    def from_gguf(cls, path: str, display_name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build from a single .gguf file: config and tokenizer are extracted
        to a sidecar HF-layout directory (``<path>.hf``); weights load
        straight from the GGUF."""
        from .gguf import extract_model_dir

        hf_dir = extract_model_dir(path)
        name = display_name or os.path.basename(path).removesuffix(".gguf")
        card = cls.from_local_path(hf_dir, name)
        card.gguf_path = path
        return card

    @classmethod
    def from_local_path(cls, path: str, display_name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build from an HF-layout model directory (config.json + tokenizer
        files) or a single .gguf file."""
        if path.endswith(".gguf"):
            return cls.from_gguf(path, display_name)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"model directory {path!r} not found")
        name = display_name or os.path.basename(os.path.normpath(path))
        card = cls(display_name=name, model_path=path)

        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                card.model_config = json.load(f)
            card.context_length = int(
                card.model_config.get("max_position_embeddings")
                or card.model_config.get("n_positions")
                or card.context_length
            )
            eos = card.model_config.get("eos_token_id")
            if isinstance(eos, int):
                card.eos_token_ids = [eos]
            elif isinstance(eos, list):
                card.eos_token_ids = [int(e) for e in eos]

        tok_json = os.path.join(path, "tokenizer.json")
        if os.path.exists(tok_json):
            card.tokenizer_file = tok_json

        tok_cfg_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(tok_cfg_path):
            with open(tok_cfg_path) as f:
                tok_cfg = json.load(f)
            card.chat_template = tok_cfg.get("chat_template")
            card.bos_token = _token_str(tok_cfg.get("bos_token"))
            card.eos_token = _token_str(tok_cfg.get("eos_token"))

        card.mdcsum = card.checksum()
        return card

    def checksum(self) -> str:
        """Stable content hash over the serialized card (reference: mdcsum)."""
        payload = {
            "display_name": self.display_name,
            "context_length": self.context_length,
            "chat_template": self.chat_template,
            "bos_token": self.bos_token,
            "eos_token": self.eos_token,
            "eos_token_ids": self.eos_token_ids,
        }
        if self.tokenizer_file and os.path.exists(self.tokenizer_file):
            h = hashlib.blake2b(digest_size=8)
            with open(self.tokenizer_file, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            payload["tokenizer_digest"] = h.hexdigest()
        return hashlib.blake2b(
            json.dumps(payload, sort_keys=True).encode(), digest_size=16
        ).hexdigest()


def _token_str(raw: Any) -> Optional[str]:
    """tokenizer_config token entries are either strings or {'content': ...}."""
    if raw is None:
        return None
    if isinstance(raw, str):
        return raw
    if isinstance(raw, dict):
        return raw.get("content")
    return None
