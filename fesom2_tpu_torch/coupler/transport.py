"""External-model coupling endpoint: socket transport for the OASIS-role
exchange.

Reference: ``src/cpl_driver.F90:1-721`` couples FESOM to a separately
launched atmosphere executable through OASIS3-MCT (MPI intercommunicator +
named coupling fields).  The TPU-native equivalent keeps the same contract
— named fields, put/get, blocking receive at coupling events — over a
Unix-domain (or TCP) stream socket, so an EXTERNAL atmosphere process can
couple without sharing an MPI world with the model's runtime:

- :class:`OasisEndpoint`: the ocean-side server.  A background thread
  accepts connections and serves a named-field mailbox; the ocean's
  :class:`~fesom2_tpu_torch.coupler.oasis.CplDriver` reads/writes the same
  mailbox in-process (the endpoint IS its transport).
- :class:`SocketTransport`: the remote-side client (used by the
  atmosphere model, or by tests standing in for one) with the same
  ``put(name, field)`` / ``get(name)`` interface as InMemoryTransport,
  plus a blocking ``get(..., timeout=s)`` mirroring OASIS's blocking
  receive semantics.

The port's own copy of ``fesom2_tpu/coupler/transport.py`` (numpy and the
standard library); the wire format is the same byte for byte, so a JAX
endpoint and a port client talk, and the other way round.

Wire format per message (little-endian):
  op      u8   'P' put | 'G' get | 'D' data reply | 'N' none reply
  nlen    u32  field-name length, then name bytes
  for P/D: dtype u8 (0=f32, 1=f64), ndim u8, shape u32*ndim, raw payload
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

_DTYPES = {0: np.float32, 1: np.float64}
_DCODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}


def _send_msg(sock, op: bytes, name: str, arr: Optional[np.ndarray] = None):
    nb = name.encode()
    buf = [op, struct.pack("<I", len(nb)), nb]
    if arr is not None:
        arr = np.ascontiguousarray(arr)
        code = _DCODES[arr.dtype]
        buf.append(struct.pack("<BB", code, arr.ndim))
        buf.append(struct.pack(f"<{arr.ndim}I", *arr.shape))
        buf.append(arr.tobytes())
    sock.sendall(b"".join(buf))


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    while n > 0:
        c = sock.recv(n)
        if not c:
            raise ConnectionError("coupling peer closed the connection")
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_msg(sock) -> Tuple[bytes, str, Optional[np.ndarray]]:
    op = _recv_exact(sock, 1)
    (nlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    name = _recv_exact(sock, nlen).decode()
    if op in (b"P", b"D"):
        code, ndim = struct.unpack("<BB", _recv_exact(sock, 2))
        shape = struct.unpack(f"<{ndim}I", _recv_exact(sock, 4 * ndim))
        dt = np.dtype(_DTYPES[code])
        n = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(_recv_exact(sock, n * dt.itemsize), dt)
        return op, name, arr.reshape(shape)
    return op, name, None


class OasisEndpoint:
    """Ocean-side coupling endpoint (server + in-process transport).

    Usage:
        ep = OasisEndpoint("/tmp/oasis.sock")        # or ("host", port)
        driver = CplDriver(mesh, ep)                 # transport interface
        ... launch the atmosphere process pointing at the same address ...
        ep.close()
    """

    def __init__(self, address):
        self._box: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        if isinstance(address, str):
            if os.path.exists(address):
                os.unlink(address)
            self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._srv.bind(address)
        else:
            self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind(address)
        self.address = self._srv.getsockname()
        self._srv.listen(4)
        self._closing = False
        self._conns = []
        self._handlers = []
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # -- transport interface (in-process side) ------------------------------
    def put(self, name: str, field):
        with self._cv:
            self._box[name] = np.asarray(field)
            self._cv.notify_all()

    def get(self, name: str, timeout: float = None) -> Optional[np.ndarray]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while name not in self._box:
                if deadline is None:
                    return None
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._cv.wait(left)
            return self._box[name]

    # -- server side ---------------------------------------------------------
    def _serve(self):
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            if self._closing:
                conn.close()
                return
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            with self._lock:
                self._conns.append(conn)
                self._handlers.append(t)
            t.start()

    def _handle(self, conn):
        try:
            while True:
                op, name, arr = _recv_msg(conn)
                if op == b"P":
                    self.put(name, arr)
                elif op == b"G":
                    val = self.get(name)
                    if val is None:
                        _send_msg(conn, b"N", name)
                    else:
                        _send_msg(conn, b"D", name, val)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def close(self):
        """Shut the server down and JOIN every thread it spawned: a leaked
        accept/handler thread left alive outlives its test and its socket."""
        self._closing = True
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            handlers = list(self._handlers)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        # wake any get() blocked in _handle threads so they can exit
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
        for t in handlers:
            t.join(timeout=5.0)


class SocketTransport:
    """Remote-side client transport (the atmosphere process' view)."""

    def __init__(self, address, retry_s: float = 10.0):
        fam = socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
        self._sock = socket.socket(fam, socket.SOCK_STREAM)
        deadline = time.monotonic() + retry_s
        while True:
            try:
                self._sock.connect(address)
                break
            except (ConnectionRefusedError, FileNotFoundError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self._lock = threading.Lock()

    def put(self, name: str, field):
        with self._lock:
            _send_msg(self._sock, b"P", name, np.asarray(field))

    def get(self, name: str, timeout: float = None) -> Optional[np.ndarray]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                _send_msg(self._sock, b"G", name)
                op, _, arr = _recv_msg(self._sock)
            if op == b"D":
                return arr
            if deadline is None or time.monotonic() > deadline:
                return None
            time.sleep(0.02)

    def close(self):
        self._sock.close()
