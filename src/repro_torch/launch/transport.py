"""Tiny RPC transport for the multi-process cluster runtime: one AF_UNIX
socket per worker, ``multiprocessing.connection`` framing (length-prefixed
pickles — numpy arrays ride along for free) — a copy of the reference's
``launch/transport.py`` (standard library only). Arguments and results
are NumPy arrays and plain Python values: a pickled CUDA tensor would
start CUDA in whichever process unpickles it.

Deliberately minimal: the supervisor is the only client and drives every
worker serially, so the server accepts one connection at a time and
dispatches requests in order. That serial discipline is what makes the
chaos harness deterministic — there is no request interleaving to race.

Wire format: request ``(method, kwargs)``; response ``("ok", value)`` or
``("err", traceback_text)``. A worker SIGKILLed mid-request surfaces as
``EOFError``/``ConnectionError`` in the supervisor's ``call`` — the death
signal the chaos supervisor's detect state consumes.
"""

from __future__ import annotations

import os
import time
import traceback
from multiprocessing.connection import Client, Listener
from typing import Any, Optional

AUTHKEY = b"weips-runtime"


class WorkerDied(ConnectionError):
    """A call could not complete because the worker's socket went away."""


class RpcServer:
    """Worker-side request loop over a unix socket."""

    def __init__(self, socket_path: str, handler):
        """``handler(method, kwargs)`` returns the result value (raising
        is fine — the traceback travels back to the caller)."""
        os.makedirs(os.path.dirname(socket_path), exist_ok=True)
        if os.path.exists(socket_path):        # stale socket from a killed
            os.unlink(socket_path)             # predecessor of this slot
        self.listener = Listener(socket_path, family="AF_UNIX",
                                 authkey=AUTHKEY)
        self.handler = handler

    def serve_forever(self) -> None:
        """Accept supervisor connections until a ``shutdown`` request.
        A dropped connection (supervisor restart) loops back to accept."""
        while True:
            try:
                conn = self.listener.accept()
            except (OSError, EOFError):
                continue
            try:
                while True:
                    method, kwargs = conn.recv()
                    if method == "shutdown":
                        conn.send(("ok", None))
                        return
                    try:
                        conn.send(("ok", self.handler(method, kwargs)))
                    except Exception:
                        conn.send(("err", traceback.format_exc()))
            except (EOFError, OSError, ConnectionError):
                continue
            finally:
                conn.close()


class RpcClient:
    """Supervisor-side handle to one worker."""

    def __init__(self, socket_path: str, connect_timeout: float = 30.0):
        self.socket_path = socket_path
        self.connect_timeout = connect_timeout
        self._conn = None

    def connect(self) -> None:
        """Retry until the worker binds its socket (process startup pays
        the torch import; SIGKILL respawns rebind the same path)."""
        deadline = time.monotonic() + self.connect_timeout
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                self._conn = Client(self.socket_path, family="AF_UNIX",
                                    authkey=AUTHKEY)
                return
            except (FileNotFoundError, ConnectionRefusedError,
                    EOFError, OSError) as e:
                last = e
                time.sleep(0.02)
        raise WorkerDied(
            f"could not connect to {self.socket_path}: {last!r}")

    def call(self, method: str, **kwargs) -> Any:
        if self._conn is None:
            self.connect()
        try:
            self._conn.send((method, kwargs))
            status, value = self._conn.recv()
        except (EOFError, OSError, ConnectionError) as e:
            self.close()
            raise WorkerDied(
                f"worker at {self.socket_path} died during "
                f"{method!r}: {e!r}") from e
        if status == "err":
            raise RuntimeError(
                f"remote {method!r} failed:\n{value}")
        return value

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None
