"""The `Annotated` stream envelope.

Every response item that crosses a process boundary is wrapped in an
SSE-compatible envelope carrying exactly one of: data, event, comment, or error.
Reference parity: lib/runtime/src/protocols/annotated.rs:32-150.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Generic, Optional, TypeVar

T = TypeVar("T")


@dataclass
class Annotated(Generic[T]):
    data: Optional[T] = None
    id: Optional[str] = None
    event: Optional[str] = None
    comment: list[str] = field(default_factory=list)

    ERROR_EVENT = "error"

    @classmethod
    def from_data(cls, data: T, id: Optional[str] = None) -> "Annotated[T]":
        return cls(data=data, id=id)

    @classmethod
    def from_error(cls, message: str, id: Optional[str] = None) -> "Annotated[T]":
        return cls(event=cls.ERROR_EVENT, comment=[message], id=id)

    @classmethod
    def from_annotation(cls, event: str, value: Any) -> "Annotated[T]":
        import json

        return cls(event=event, comment=[json.dumps(value)])

    @property
    def is_error(self) -> bool:
        return self.event == self.ERROR_EVENT

    def error_message(self) -> Optional[str]:
        if not self.is_error:
            return None
        return "; ".join(self.comment) if self.comment else "unknown error"

    # -- wire form ---------------------------------------------------------

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        if self.data is not None:
            out["data"] = self.data
        if self.id is not None:
            out["id"] = self.id
        if self.event is not None:
            out["event"] = self.event
        if self.comment:
            out["comment"] = self.comment
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Annotated[Any]":
        return cls(
            data=d.get("data"),
            id=d.get("id"),
            event=d.get("event"),
            comment=list(d.get("comment") or []),
        )

