"""Debug-mode lock-ownership assertions for the serving layer (port of
repro.serve.locking).

`repro-lint`'s lock pass (DESIGN.md §11) proves *lexically* that guarded
state is only touched under ``with self._lock``, but it cannot see through
dynamic dispatch or code the pass does not scan.  ``assert_owns_lock`` is
the runtime complement: drop it at the top of a mutation site and any
call path that reaches it without the lock fails loudly under ``python``
(the default, ``__debug__`` true) while compiling to a no-op under
``python -O`` — same contract as ``assert``.

Ownership detection is best-effort by lock flavor:

* ``threading.RLock`` — CPython's ``_is_owned()`` answers exactly
  "does *this* thread hold it".  This is the strong, preferred case and
  what every gateway lock uses.
* plain ``threading.Lock`` — not owner-tracked, so we probe with a
  non-blocking acquire: if the acquire *succeeds* the lock was free and
  the caller definitely did not hold it (we release and fail).  If it
  fails, *someone* holds it — possibly another thread — so we accept.
  One-sided, but it still catches the common bug of forgetting the
  ``with`` entirely in single-threaded tests.
"""
from __future__ import annotations

__all__ = ["assert_owns_lock"]


def _owns(lock) -> bool:
    is_owned = getattr(lock, "_is_owned", None)
    if is_owned is not None:  # RLock: exact per-thread answer
        return bool(is_owned())
    # Plain Lock: probe.  Acquiring means it was free => caller can't own it.
    if lock.acquire(blocking=False):
        lock.release()
        return False
    return True


def assert_owns_lock(lock, what: str = "guarded state") -> None:
    """Raise ``AssertionError`` if the calling thread does not hold *lock*.

    No-op under ``python -O`` (mirrors ``assert`` semantics), so hot
    paths may call it unconditionally.
    """
    if not __debug__:
        return
    if not _owns(lock):
        raise AssertionError(
            f"{what} touched without holding {lock!r}; wrap the call "
            "site in `with lock:` (see DESIGN.md §11)"
        )
