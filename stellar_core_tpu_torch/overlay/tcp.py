"""TCPPeer + TCPServer: non-blocking socket transport for the overlay.

Reference: src/overlay/TCPPeer.{h,cpp} — asio sockets owned by the
VirtualClock's io context.  Here a selectors.DefaultSelector is pumped from
the clock loop (VirtualClock.add_io_pump), so socket IO interleaves with
timers exactly like asio handlers do: each crank polls ready sockets with
zero timeout, reads feed Peer.data_received, writes drain per-peer buffers.
"""

from __future__ import annotations

import errno
import selectors
import socket
from typing import Dict, Optional

from ..util import logging as slog
from .peer import Peer

log = slog.get("Overlay")

READ_CHUNK = 256 * 1024
MAX_WRITE_BUFFER = 64 * 1024 * 1024


class TCPPeer(Peer):
    def __init__(self, overlay, we_called_remote: bool,
                 sock: socket.socket, transport: "TCPTransport"):
        super().__init__(overlay, we_called_remote)
        self.sock = sock
        self.transport = transport
        self._write_buf = bytearray()
        self._registered = False

    # -- Peer transport interface -------------------------------------------
    def _write_bytes(self, data: bytes) -> None:
        if self.sock is None:
            return
        self._write_buf += data
        if len(self._write_buf) > MAX_WRITE_BUFFER:
            self.drop("write buffer overflow")
            return
        self._try_flush()
        self.transport.update_interest(self)

    def _close_transport(self) -> None:
        if self.sock is not None:
            self.transport.forget(self)
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    # -- IO pump callbacks ---------------------------------------------------
    def _try_flush(self) -> None:
        while self._write_buf:
            try:
                n = self.sock.send(self._write_buf)
            except BlockingIOError:
                return
            except OSError as e:
                self.drop(f"send error: {e}")
                return
            if n <= 0:
                return
            del self._write_buf[:n]

    def on_readable(self) -> None:
        try:
            data = self.sock.recv(READ_CHUNK)
        except BlockingIOError:
            return
        except OSError as e:
            self.drop(f"recv error: {e}")
            return
        if not data:
            self.drop("connection closed by peer")
            return
        self.data_received(data)

    def on_writable(self) -> None:
        if self.state == Peer.CONNECTING:
            # outbound connect completed (or failed)
            err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self.drop(f"connect failed: {errno.errorcode.get(err, err)}")
                return
            self.connect_handler()
        # IO-ready edge: a pending coalescing run rides this writability
        # event as one frame/one syscall instead of waiting for the next
        # crank-edge flush
        self._flush_batch()
        self._try_flush()
        self.transport.update_interest(self)

    def wants_write(self) -> bool:
        return bool(self._write_buf) or self.state == Peer.CONNECTING


class TCPTransport:
    """Owns the selector, the listening socket and the socket<->peer map;
    `pump()` is registered as a clock IO pump."""

    def __init__(self, overlay, listen_port: int = 0,
                 host: str = "127.0.0.1"):
        self.overlay = overlay
        self.selector = selectors.DefaultSelector()
        self.peers: Dict[socket.socket, TCPPeer] = {}
        self.listen_sock: Optional[socket.socket] = None
        self.host = host
        if listen_port is not None:
            self.listen_sock = socket.socket(socket.AF_INET,
                                             socket.SOCK_STREAM)
            self.listen_sock.setsockopt(socket.SOL_SOCKET,
                                        socket.SO_REUSEADDR, 1)
            self.listen_sock.bind((host, listen_port))
            self.listen_sock.listen(64)
            self.listen_sock.setblocking(False)
            self.selector.register(self.listen_sock, selectors.EVENT_READ)
            overlay.listening_port = self.listen_sock.getsockname()[1]
        overlay.clock.add_io_pump(self.pump)

    # -- connections ---------------------------------------------------------
    def connect(self, host: str, port: int) -> TCPPeer:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        sync_error: Optional[OSError] = None
        try:
            sock.connect((host, port))
        except BlockingIOError:
            pass
        except OSError as e:
            # immediate connect failure (unroutable address, exhausted
            # ports): register the peer then drop it through the normal
            # path so PeerManager backoff records the failure instead of
            # the dial crashing the crank loop
            sync_error = e
        peer = TCPPeer(self.overlay, we_called_remote=True, sock=sock,
                       transport=self)
        peer.dial_addr = (host, port)   # feeds PeerManager backoff on drop
        self.peers[sock] = peer
        self.selector.register(sock, selectors.EVENT_READ
                               | selectors.EVENT_WRITE)
        peer._registered = True
        self.overlay._register_peer(peer)
        if sync_error is not None:
            peer.drop(f"connect failed: {sync_error}")
        return peer

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self.listen_sock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            peer = TCPPeer(self.overlay, we_called_remote=False, sock=sock,
                           transport=self)
            self.peers[sock] = peer
            self.selector.register(sock, selectors.EVENT_READ)
            peer._registered = True
            self.overlay._register_peer(peer)
            peer.connect_handler()

    def update_interest(self, peer: TCPPeer) -> None:
        if peer.sock is None or not peer._registered:
            return
        events = selectors.EVENT_READ
        if peer.wants_write():
            events |= selectors.EVENT_WRITE
        try:
            self.selector.modify(peer.sock, events)
        except KeyError:
            pass

    def forget(self, peer: TCPPeer) -> None:
        if peer.sock is not None:
            try:
                self.selector.unregister(peer.sock)
            except KeyError:
                pass
            self.peers.pop(peer.sock, None)
            peer._registered = False

    # -- the pump ------------------------------------------------------------
    def pump(self) -> int:
        """One zero-timeout poll; returns number of IO events handled."""
        handled = 0
        try:
            events = self.selector.select(timeout=0)
        except (OSError, ValueError):
            # ValueError: selector already closed (shutdown race between a
            # signal handler's close() and the crank loop's pump)
            return 0
        for key, mask in events:
            if key.fileobj is self.listen_sock:
                self._accept()
                handled += 1
                continue
            peer = self.peers.get(key.fileobj)
            if peer is None:
                continue
            if mask & selectors.EVENT_WRITE:
                peer.on_writable()
                handled += 1
            if mask & selectors.EVENT_READ and peer.sock is not None:
                peer.on_readable()
                handled += 1
        return handled

    def close(self) -> None:
        self.overlay.clock.remove_io_pump(self.pump)
        for peer in list(self.peers.values()):
            peer.drop("shutdown")
        if self.listen_sock is not None:
            try:
                self.selector.unregister(self.listen_sock)
            except KeyError:
                pass
            self.listen_sock.close()
            self.listen_sock = None
        self.selector.close()
