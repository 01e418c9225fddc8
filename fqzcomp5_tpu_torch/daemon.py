"""Pre-warmed CLI daemon of the port: pay interpreter, torch and numpy
start-up once.

The counterpart of the JAX package's daemon.  ``--daemon`` keeps one
process alive with the port's modules imported; each request forks a
child that inherits them warm and runs the ordinary ``cli.main`` with
the client's stdin, stdout and stderr (file descriptors passed over the
unix socket with SCM_RIGHTS), cwd, umask and environment, so pipes and
redirections behave as in a direct run.

Protocol (unix stream socket, one request per connection):

    client -> one JSON line {"argv": [...], "cwd": "...", "umask": N,
                             "env": {FQZ5_*, TMPDIR, CUDA_VISIBLE_DEVICES}}
              with ancillary fds [stdin, stdout, stderr]
    server -> one JSON line {"rc": <exit code>}, or {"stale": true}
              when the code on disk changed (the job did not run)

    {"op": "ping"} -> {"ok": true}      liveness probe
    {"op": "stop"} -> {"ok": true}      shut the daemon down

Each job runs on a handler thread (fork, wait, reply), so concurrent
clients run in parallel.  The job is the leader of its own process
group, and its handler waits on the child's exit and the connection at
once: when the client hangs up before the job ends (Ctrl-C, SIGKILL),
the handler sends the group SIGTERM, then SIGKILL for what is left of
it once the child has exited or KILL_GRACE_S has passed, reaps the
child and sends no reply, as a direct run would have stopped with its
caller.  A client therefore keeps its end of the connection open
until the reply arrives.  The server exits after ``idle_timeout``
seconds without a request (``FQZ5_DAEMON_IDLE`` for ``--daemon``), and
retires when the staleness token changes: the mtimes and sizes of the
port's ``.py`` sources, its kernel sources (``csrc/*.cu``, ``*.cuh``)
and the native host library.

Where it differs from the JAX package's daemon:

- its own default socket, ``fqz5-torch-daemon-{uid}.sock`` under TMPDIR
  (``FQZ5_DAEMON=<path>`` picks another), so neither package's launcher
  hands its jobs to the other's server;
- no CUDA in the server.  CUDA does not survive a fork once the parent
  has initialised it, so ``_preload`` imports torch and the port's
  modules and builds and loads the kernel library, but calls no
  ``torch.cuda`` function (``is_available`` and ``device_count``
  initialise the driver) and runs no torch compute (an OpenMP pool in
  the parent is not fork-safe either).  Each child makes its own CUDA
  context.  Whoever extends ``_preload`` keeps to this;
- ``CUDA_VISIBLE_DEVICES`` is forwarded with ``FQZ5_*`` and TMPDIR, so a
  request runs on the card a direct run would use, and a forwarded
  variable the client does not set is unset in the child;
- a client that connects and stalls cannot wedge the accept loop: its
  request must arrive within RECV_TIMEOUT_S, and the fds of every
  request that is not a job are closed;
- once a job request has been delivered, a lost reply is a failure:
  ``request`` reports it and returns LOST_RC, and the caller must not
  run the job again in-process;
- a job whose client hangs up before it ends is killed with its process
  group, so Ctrl-C on a client (``daemon.request`` or the C client,
  ``bin/fqz5-torch``) stops the job as it would stop a direct run.
"""

from __future__ import annotations

import array
import json
import os
import select
import signal
import socket
import sys
import threading
import time

_MAX_REQ = 1 << 20
RECV_TIMEOUT_S = 2.0
KILL_GRACE_S = 2.0
LOST_RC = 1
_FORWARDED = ("TMPDIR", "CUDA_VISIBLE_DEVICES")
_PKG = os.path.dirname(os.path.abspath(__file__))


def _forwarded(key: str) -> bool:
    return key.startswith("FQZ5_") or key in _FORWARDED


def default_socket_path() -> str:
    env = os.environ.get("FQZ5_DAEMON", "")
    if env and env not in ("0", "1", "auto"):
        return env
    return os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"fqz5-torch-daemon-{os.getuid()}.sock")


def _code_token():
    """(path, mtime_ns, size) of the native host library and the port's
    Python and kernel sources.  Recomputed per request; any change means
    the warm process no longer matches the code on disk."""
    from fqzcomp5_tpu_torch.codecs import native

    paths = [native._LIB_PATH]
    for dirpath, _dirs, files in os.walk(_PKG):
        if "__pycache__" in dirpath:
            continue
        paths.extend(os.path.join(dirpath, f) for f in files
                     if f.endswith((".py", ".cu", ".cuh")))
    entries = []
    for p in sorted(paths):
        try:
            st = os.stat(p)
            entries.append((p, st.st_mtime_ns, st.st_size))
        except OSError:
            entries.append((p, -1, -1))
    return tuple(entries)


def _recv_request(conn, fds: list[int]):
    """One JSON line and up to 3 ancillary fds (appended to fds as they
    arrive, so the caller closes them whatever happens).  The whole
    request must arrive within RECV_TIMEOUT_S."""
    deadline = time.monotonic() + RECV_TIMEOUT_S
    chunks: list[bytes] = []
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("request not received in time")
        conn.settimeout(left)
        data, ancdata, _flags, _addr = conn.recvmsg(
            4096, socket.CMSG_SPACE(3 * array.array("i").itemsize))
        for level, ctype, cdata in ancdata:
            if level == socket.SOL_SOCKET and ctype == socket.SCM_RIGHTS:
                a = array.array("i")
                a.frombytes(cdata[:len(cdata) - len(cdata) % a.itemsize])
                fds.extend(a)
        if not data and not ancdata:
            break
        chunks.append(data)
        if b"\n" in data:
            break
        if sum(len(c) for c in chunks) > _MAX_REQ:
            raise ValueError("request too large")
    line = b"".join(chunks).split(b"\n", 1)[0]
    if not line:
        raise ValueError("empty request")
    req = json.loads(line)
    if not isinstance(req, dict):
        raise ValueError("request must be a JSON object")
    return req


def _send_line(conn, obj) -> None:
    conn.sendall(json.dumps(obj).encode() + b"\n")


def _close_all(fds) -> None:
    for fd in fds:
        try:
            os.close(fd)
        except OSError:
            pass


def _hung_up(conn) -> bool:
    """True when the client has closed its end of the connection (EOF or
    a reset).  Stray bytes after the request line are discarded."""
    try:
        data = conn.recv(4096, socket.MSG_DONTWAIT)
    except BlockingIOError:
        return False
    except OSError:
        return True
    return not data


def _exit_fd(pid: int) -> int:
    """An fd that polls readable once child pid has exited, before it is
    reaped: the read end of a pipe whose write end a thread closes once
    waitid(WEXITED | WNOWAIT) sees the exit.  (Not a pidfd: some
    container runtimes' kernels answer pidfd_open with ENOSYS.)"""
    r, w = os.pipe()

    def watch():
        try:
            os.waitid(os.P_PID, pid, os.WEXITED | os.WNOWAIT)
        except OSError:
            pass   # already reaped: the handler is done with r
        finally:
            os.close(w)

    threading.Thread(target=watch, daemon=True).start()
    return r


def _wait_job(pid: int, conn) -> int | None:
    """Wait for job child pid or the client's hang-up, whichever comes
    first, without a polling tick: one poll over the child's exit fd
    (_exit_fd) and the connection.  Returns the child's exit code (128 +
    N for signal N), or None when the client hung up first: the job's
    process group then gets SIGTERM and, once the child has exited or
    KILL_GRACE_S has passed, SIGKILL for whatever is left of it (before
    the child is reaped, so its pid, which names the group, cannot have
    been reused), and the child is reaped."""
    exit_fd = _exit_fd(pid)
    try:
        poller = select.poll()
        poller.register(exit_fd, select.POLLIN)
        poller.register(conn.fileno(), select.POLLIN)
        cancelled = False
        while True:
            ready = dict(poller.poll())
            if exit_fd in ready:
                break
            if _hung_up(conn):
                cancelled = True
                break
        if cancelled:
            for sig in (signal.SIGTERM, signal.SIGKILL):
                try:
                    os.killpg(pid, sig)
                except OSError:
                    pass  # the group has gone
                if sig == signal.SIGTERM:
                    select.select([exit_fd], [], [], KILL_GRACE_S)
        _, status = os.waitpid(pid, 0)
    finally:
        os.close(exit_fd)
    if cancelled:
        return None
    rc = os.waitstatus_to_exitcode(status)
    return 128 - rc if rc < 0 else rc   # killed by signal N -> 128 + N


def _preload() -> None:
    """Import the heavy modules once so that every forked child inherits
    them warm (torch, numpy, the CLI and its engines, the kernel
    wrappers), load the native host library, and build and load the
    kernel library where nvcc is installed.  No torch.cuda call and no
    torch compute: see the module docstring."""
    import numpy  # noqa: F401
    import torch  # noqa: F401

    from fqzcomp5_tpu_torch import (cli, cuda_driver, drivers,  # noqa: F401
                                    fastq, inspect_tool)
    from fqzcomp5_tpu_torch.codecs import native
    from fqzcomp5_tpu_torch.ops import (_build, adaptive_batch,  # noqa: F401
                                        model_cuda, rans_cuda, rans_cuda_bnd,
                                        rans_cuda_dec, rc_cuda)

    native.lib()
    try:
        _build._nvcc()
    except RuntimeError:
        return   # no CUDA toolkit: the children run -e host only
    _build.lib()


def _run_child(req, fds) -> None:
    """Forked child: take the client's fds, cwd, umask and forwarded
    environment, and run the normal CLI main."""
    rc = 1
    try:
        # the job's own process group, which _handle kills when the
        # client hangs up (set on both sides of the fork: no race)
        os.setpgid(0, 0)
        # serve()'s SIGTERM/SIGINT handlers would raise into job code
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.SIG_DFL)
        for i, fd in enumerate(fds[:3]):
            os.dup2(fd, i)
        _close_all(fd for fd in fds if fd > 2)
        cwd = req.get("cwd")
        if cwd:
            os.chdir(cwd)
        if req.get("umask") is not None:
            os.umask(int(req["umask"]))
        env = {k: str(v) for k, v in (req.get("env") or {}).items()
               if _forwarded(k)}
        for k in [k for k in os.environ if _forwarded(k) and k not in env]:
            del os.environ[k]
        os.environ.update(env)
        sys.stdout.flush()
        sys.stderr.flush()
        from fqzcomp5_tpu_torch.cli import main as cli_main

        rc = int(cli_main([str(a) for a in req.get("argv", [])]) or 0)
        sys.stdout.flush()
        sys.stderr.flush()
    except SystemExit as e:
        rc = int(e.code or 0) if not isinstance(e.code, str) else 1
    except BaseException:  # noqa: BLE001 - the child must never escape
        import traceback

        traceback.print_exc()
        rc = 1
    finally:
        os._exit(rc)


def serve(socket_path: str | None = None, *, quiet: bool = False,
          idle_timeout: float | None = None) -> int:
    """Foreground server loop (``--daemon``).  Returns 0 after a
    ``stop``, SIGTERM or SIGINT, the idle timeout or a stale-code
    retirement; 1 when a daemon already answers on the socket or it
    cannot be bound."""
    import stat as stat_m

    path = socket_path or default_socket_path()
    try:
        if stat_m.S_ISSOCK(os.stat(path).st_mode):
            if request(path, None, op="ping") is not None:
                print(f"fqz5 daemon already running on {path}",
                      file=sys.stderr)
                return 1
            os.unlink(path)  # a stale socket
    except FileNotFoundError:
        pass

    _preload()
    token = _code_token()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
    except OSError as e:
        print(f"ERROR: cannot bind {path}: {e}", file=sys.stderr)
        return 1
    os.chmod(path, 0o600)
    bound_ino = os.stat(path).st_ino
    srv.listen(16)
    stop = False

    def _sigterm(_sig, _frm):
        raise InterruptedError

    old_term = signal.signal(signal.SIGTERM, _sigterm)
    old_int = signal.signal(signal.SIGINT, _sigterm)
    if not quiet:
        print(f"fqz5 daemon listening on {path}", file=sys.stderr,
              flush=True)
    srv.settimeout(idle_timeout or None)
    workers: list[threading.Thread] = []

    def _handle(conn, req, fds):
        """One job: fork, wait for the child or the client's hang-up,
        relay rc (or cancel the job).  No imports here: the fork must
        never race an import lock."""
        try:
            pid = os.fork()
            if pid == 0:
                srv.close()
                conn.close()
                _run_child(req, fds)  # never returns
            try:
                os.setpgid(pid, pid)
            except OSError:
                pass  # the child has set it already, or has exited
            rc = _wait_job(pid, conn)
            if rc is not None:
                try:
                    _send_line(conn, {"rc": rc})
                except OSError:
                    pass  # the client went away
        finally:
            _close_all(fds)
            conn.close()

    try:
        while not stop:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                workers = [t for t in workers if t.is_alive()]
                if workers:
                    continue  # jobs in flight: not idle
                if not quiet:
                    print("fqz5 daemon: idle timeout, exiting",
                          file=sys.stderr)
                break
            fds: list[int] = []
            try:
                req = _recv_request(conn, fds)
                conn.settimeout(None)
            except InterruptedError:
                _close_all(fds)
                conn.close()
                raise
            except Exception:  # noqa: BLE001 - a bad or stalled client
                _close_all(fds)
                conn.close()
                continue
            op = req.get("op")
            stale = op is None and _code_token() != token
            if op is not None or stale:
                # not a job: answer, close its fds; a stale server
                # retires, and the client runs the job in-process
                _close_all(fds)
                try:
                    _send_line(conn, {"stale": True} if stale
                               else {"ok": True})
                except OSError:
                    pass
                conn.close()
                stop = stale or op == "stop"
                continue
            t = threading.Thread(target=_handle, args=(conn, req, fds),
                                 daemon=True)
            t.start()
            workers = [w for w in workers if w.is_alive()] + [t]
    except InterruptedError:
        pass  # SIGTERM or SIGINT
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
        srv.close()
        for t in workers:  # let jobs in flight finish and reply
            t.join(timeout=600)
        try:
            # only remove the socket if it is still ours: a retiring
            # server may race a fresh one that bound the path again
            if os.stat(path).st_ino == bound_ino:
                os.unlink(path)
        except OSError:
            pass
    return 0


def request(socket_path: str | None, argv, *, op: str | None = None,
            timeout: float = 5.0):
    """Client side.  With op ("ping", "stop"): True when a daemon
    answers, else None.  Otherwise runs argv through the daemon with
    this process's stdin, stdout and stderr and returns the job's exit
    code; None when no daemon took the job (none answers, or it is
    stale), so the caller runs it in-process; LOST_RC, with ERROR: on
    stderr, when the request was delivered and the reply was lost (the
    job may have run: the caller must not run it again).  The call
    blocks until the job ends."""
    path = socket_path or default_socket_path()
    try:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(timeout)
        conn.connect(path)
    except OSError:
        return None
    with conn:
        try:
            if op:
                _send_line(conn, {"op": op})
            else:
                env = {k: v for k, v in os.environ.items()
                       if _forwarded(k) and k != "FQZ5_DAEMON"}
                um = os.umask(0)
                os.umask(um)
                msg = json.dumps({"argv": list(argv), "cwd": os.getcwd(),
                                  "umask": um, "env": env}).encode() + b"\n"
                conn.sendmsg([msg], [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                                      array.array("i", [0, 1, 2]).tobytes())])
        except OSError:
            return None   # not delivered
        try:
            conn.settimeout(None if not op else timeout)  # jobs run long
            buf = b""
            while b"\n" not in buf:
                d = conn.recv(4096)
                if not d:
                    raise ConnectionError("connection closed")
                buf += d
            rep = json.loads(buf.split(b"\n", 1)[0])
        except (OSError, ValueError) as e:
            if op:
                return None
            print(f"ERROR: the fqz5 daemon on {path} took the request and "
                  f"gave no reply ({e}); the job may have run",
                  file=sys.stderr)
            return LOST_RC
    if op:
        return rep.get("ok")
    if rep.get("stale"):
        return None
    return rep.get("rc", LOST_RC)


def stop(socket_path: str | None = None) -> bool:
    return bool(request(socket_path, None, op="stop"))


def spawn(socket_path: str | None = None) -> None:
    """Start a detached background daemon (``python -m
    fqzcomp5_tpu_torch.cli --daemon --daemon-quiet [SOCK]``), best
    effort; it exits after FQZ5_DAEMON_IDLE seconds (default 1800)
    without a request.  A lost spawn race is harmless: the second server
    finds the first on its socket and exits."""
    import subprocess

    repo = os.path.dirname(_PKG)
    argv = [sys.executable, "-m", "fqzcomp5_tpu_torch.cli", "--daemon",
            "--daemon-quiet", *([socket_path] if socket_path else [])]
    env = dict(os.environ)
    env.setdefault("FQZ5_DAEMON_IDLE", "1800")
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    try:
        subprocess.Popen(argv, cwd=repo, env=env, start_new_session=True,
                         stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL, close_fds=True)
    except OSError:
        pass  # best effort by design
