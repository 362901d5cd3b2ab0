"""Server-Sent Events line codec.

Emits SSE messages (``data:``, ``event:``, ``:`` comments, id) and the
OpenAI ``[DONE]`` sentinel, symmetric with the :class:`Annotated` envelope.
Reference parity: SseLineCodec / Message / create_message_stream
(lib/llm/src/protocols/codec.rs:36-295).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from ...runtime.annotated import Annotated

DONE_SENTINEL = "[DONE]"


@dataclass
class SseMessage:
    data: Optional[str] = None
    event: Optional[str] = None
    id: Optional[str] = None
    comments: list[str] = field(default_factory=list)

    def encode(self) -> str:
        """Render as an SSE frame (without the trailing blank-line separator)."""
        lines: list[str] = []
        for c in self.comments:
            lines.append(f": {c}")
        if self.event is not None:
            lines.append(f"event: {self.event}")
        if self.id is not None:
            lines.append(f"id: {self.id}")
        if self.data is not None:
            for chunk in self.data.split("\n"):
                lines.append(f"data: {chunk}")
        return "\n".join(lines)

    @classmethod
    def from_annotated(cls, item: Annotated) -> "SseMessage":
        return cls(
            data=None if item.data is None else json.dumps(item.data),
            event=item.event,
            id=item.id,
            comments=list(item.comment),
        )
