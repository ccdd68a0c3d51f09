"""Error propagation — the hypre_error.h analog (port of
hypre_tpu/utils/errors.py).

The reference keeps a process-global error flag with bitmask codes and
query/clear entry points (utilities/hypre_error.h:18-31).  Host-side
errors raise HypreError AND set the global flag so callers using the
reference's flag-polling style keep working.
"""

from __future__ import annotations

GENERIC = 1
MEMORY = 2
ARG = 4
CONV = 256  # solver did not converge

_error_flag: int = 0


def set_error(code: int, msg: str | None = None) -> int:
    """Record `code` in the global flag without raising; returns it."""
    global _error_flag
    _error_flag |= int(code)
    return int(code)


def get_error() -> int:
    """HYPRE_GetError: the accumulated bitmask (0 = no error)."""
    return _error_flag


def check_error(ierr: int, code: int) -> bool:
    """HYPRE_CheckError: does `ierr` contain `code`?"""
    return bool(int(ierr) & int(code))


def clear_errors() -> None:
    """HYPRE_ClearAllErrors."""
    global _error_flag
    _error_flag = 0


def describe_error(code: int) -> str:
    """HYPRE_DescribeError (hypre_error.c)."""
    if code == 0:
        return "[No error] "
    parts = []
    if code & GENERIC:
        parts.append("[Generic error] ")
    if code & MEMORY:
        parts.append("[Memory error] ")
    if code & ARG:
        parts.append("[Invalid argument] ")
    if code & CONV:
        parts.append("[Method did not converge] ")
    return "".join(parts) or "[Unknown error code] "


class HypreError(RuntimeError):
    """Raised for host-side errors; constructing one also records its
    code in the global flag (hypre_error_w_msg does both)."""

    GENERIC = GENERIC
    MEMORY = MEMORY
    ARG = ARG
    CONV = CONV

    def __init__(self, msg: str, code: int = GENERIC):
        super().__init__(msg)
        self.code = int(code)
        set_error(self.code)


def arg_error(msg: str) -> HypreError:
    """hypre_error_in_arg analog: build (and record) an ARG error."""
    return HypreError(msg, ARG)


def generic_error(msg: str) -> HypreError:
    """hypre_error_w_msg(HYPRE_ERROR_GENERIC, ...) analog."""
    return HypreError(msg, GENERIC)
