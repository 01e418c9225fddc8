"""The port's pre-warmed CLI daemon (fqzcomp5_tpu_torch.daemon), its CLI
verbs and its launcher (python -m fqzcomp5_tpu_torch.launcher), on the
CPU: every request runs -e host, as no card is visible.

Covers what tests/test_daemon.py and tests/test_launcher.py cover for the
JAX package's daemon (ping and stop, archives equal to a direct run,
stdio fds and stdout pipes, exit codes, isolation between requests, the
client's fallback, the verbs and a stale socket, the launcher's routing
and its opt-out) and what the port's differs in: staleness after a
kernel source changes, its own default socket, CUDA_VISIBLE_DEVICES
forwarded, a stalled client that cannot wedge the server and whose fds
are closed, a reply lost after delivery that fails the job instead of
running it again, and a job cancelled when its client dies.  Each test
has its own socket under tmp_path, every wait has a deadline and every
subprocess a time limit, and no server outlives its test;
FQZ5_NO_DAEMON=1 is set wherever the launcher could spawn one.
"""

import array
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import pytest

from fqzcomp5_tpu import daemon as jdaemon
from fqzcomp5_tpu_torch import cli, daemon, launcher
from tests import torch_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START_S = 90


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["FQZ5_NO_DAEMON"] = "1"
    env.pop("FQZ5_DAEMON", None)
    env.update(extra)
    return env


def _wait_ping(sock, proc):
    deadline = time.monotonic() + START_S
    while time.monotonic() < deadline:
        if daemon.request(sock, None, op="ping"):
            return
        if proc.poll() is not None:
            raise RuntimeError("daemon died: "
                               + proc.stderr.read().decode()[-800:])
        time.sleep(0.1)
    proc.kill()
    proc.wait()
    raise RuntimeError("daemon never answered ping")


def _stop(sock, proc):
    daemon.stop(sock)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _serve(sock, env=None, cwd=ROOT):
    """A port daemon on sock in a subprocess, answering ping."""
    p = subprocess.Popen(
        [sys.executable, "-c",
         "from fqzcomp5_tpu_torch.daemon import serve; "
         f"raise SystemExit(serve({sock!r}, quiet=True))"],
        env=env or _env(), cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    _wait_ping(sock, p)
    return p


@pytest.fixture()
def live(tmp_path):
    sock = str(tmp_path / "d.sock")
    p = _serve(sock)
    yield sock, p
    _stop(sock, p)


def _direct(tmp_path, argv, name):
    out = tmp_path / name
    assert cli.main(argv + [str(out)]) == 0
    return out.read_bytes()


def test_ping_and_stop(live, tmp_path):
    sock, p = live
    assert daemon.request(sock, None, op="ping") is True
    assert daemon.stop(sock) is True
    p.wait(timeout=30)
    assert p.returncode == 0
    assert not os.path.exists(sock)
    assert daemon.request(sock, None, op="ping") is None


def test_archive_through_the_daemon_equals_a_direct_run(live, tmp_path,
                                                        data_dir):
    sock, _ = live
    sample = str(data_dir / "sample.fastq")
    for lvl in ("-1", "-5"):
        arc = tmp_path / f"d{lvl}.fqz5"
        assert daemon.request(sock, ["-e", "host", lvl, "-V", sample,
                                     str(arc)]) == 0
        assert arc.read_bytes() == _direct(
            tmp_path, ["-e", "host", lvl, "-V", sample], f"p{lvl}.fqz5")
        out = tmp_path / f"rt{lvl}.fastq"
        assert daemon.request(sock, ["-e", "host", "-d", str(arc),
                                     str(out)]) == 0
        assert out.read_bytes() == open(sample, "rb").read()


_CLIENT = """
import sys
from fqzcomp5_tpu_torch import daemon
sys.exit(daemon.request(sys.argv[1], sys.argv[2:]))
"""


def test_stdio_fds_and_stdout_pipes(live, tmp_path, data_dir):
    """The client's stdin, stdout and stderr reach the job: an encode
    from stdin to stdout, a decode to stdout, and -v's report on the
    client's stderr."""
    sock, _ = live
    sample = data_dir / "sample.fastq"
    env = _env()
    r = subprocess.run(
        [sys.executable, "-c", _CLIENT, sock, "-e", "host", "-1", "-v"],
        input=sample.read_bytes(), capture_output=True, env=env, cwd=ROOT,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert b"blocks combined" in r.stderr
    arc = tmp_path / "stdin.fqz5"
    arc.write_bytes(r.stdout)
    r = subprocess.run(
        [sys.executable, "-c", _CLIENT, sock, "-e", "host", "-d", str(arc)],
        capture_output=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == sample.read_bytes()


def test_exit_codes_relayed_and_requests_isolated(live, tmp_path, data_dir):
    """A failing request relays its exit code and does not poison the
    next one (a fork per request)."""
    sock, _ = live
    sample = str(data_dir / "sample.fastq")
    assert daemon.request(sock, ["-e", "host", "-1", str(tmp_path / "no.fq"),
                                 str(tmp_path / "o.fqz5")]) == 1
    assert daemon.request(sock, ["-e", "host", "-d", sample,
                                 str(tmp_path / "x")]) == 1
    assert daemon.request(sock, ["-e", "host", "-1", "-Z", sample]) == 1
    arc = tmp_path / "ok.fqz5"
    assert daemon.request(sock, ["-e", "host", "-1", "-V", sample,
                                 str(arc)]) == 0
    assert arc.stat().st_size > 0
    assert daemon.request(sock, None, op="ping") is True


def test_client_falls_back_without_a_daemon(tmp_path):
    absent = str(tmp_path / "absent.sock")
    assert daemon.request(absent, ["-1"]) is None
    assert daemon.request(absent, None, op="ping") is None
    assert daemon.stop(absent) is False


def test_cli_verbs_and_a_stale_socket(tmp_path):
    """--daemon serves (reclaiming a dead socket file), --daemon-stop
    stops it, and stopping again reports no daemon."""
    sock = str(tmp_path / "v.sock")
    s = socket.socket(socket.AF_UNIX)
    s.bind(sock)
    s.close()   # a dead socket file left behind
    entry = [sys.executable, "-m", "fqzcomp5_tpu_torch.cli"]
    p = subprocess.Popen(entry + ["--daemon", sock], env=_env(), cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        _wait_ping(sock, p)
        r = subprocess.run(entry + ["--daemon", "--daemon-quiet", sock],
                           env=_env(), cwd=ROOT, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 1 and "already running" in r.stderr
        r = subprocess.run(entry + ["--daemon-stop", sock], env=_env(),
                           cwd=ROOT, capture_output=True, timeout=120)
        assert r.returncode == 0, r.stderr
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert b"listening on" in p.stderr.read()
    assert not os.path.exists(sock)
    r = subprocess.run(entry + ["--daemon-stop", sock], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "no daemon" in r.stderr


def test_launcher_routes_through_the_daemon(live, tmp_path, data_dir):
    """python -m fqzcomp5_tpu_torch.launcher with FQZ5_DAEMON=<socket>
    writes the direct run's archive, and a decode to the launcher's
    stdout arrives through the passed fd."""
    sock, _ = live
    sample = str(data_dir / "sample.fastq")
    arc = tmp_path / "l.fqz5"
    env = _env(FQZ5_DAEMON=sock)
    env.pop("FQZ5_NO_DAEMON")
    r = subprocess.run([sys.executable, "-m", "fqzcomp5_tpu_torch.launcher",
                        "-e", "host", "-5", "-V", sample, str(arc)],
                       env=env, cwd=ROOT, capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert arc.read_bytes() == _direct(tmp_path, ["-e", "host", "-5", "-V",
                                                  sample], "p.fqz5")
    r = subprocess.run([sys.executable, "-m", "fqzcomp5_tpu_torch.launcher",
                        "-e", "host", "-d", str(arc)], env=env, cwd=ROOT,
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == open(sample, "rb").read()


def test_launcher_routing_and_opt_out(monkeypatch, tmp_path, data_dir):
    """In-process: a daemon's answer is the result; no answer runs the
    CLI and then spawns a daemon; FQZ5_NO_DAEMON=1 or FQZ5_DAEMON=0 and
    the daemon verbs run in-process without spawning."""
    calls = []
    answer = {"rc": 7}
    monkeypatch.setattr(daemon, "request",
                        lambda s, argv, **k: calls.append(("req", argv))
                        or answer["rc"])
    monkeypatch.setattr(daemon, "spawn",
                        lambda s=None: calls.append(("spawn",)))
    monkeypatch.setattr(cli, "main",
                        lambda argv: calls.append(("cli", argv)) or 0)
    for k in ("FQZ5_NO_DAEMON", "FQZ5_DAEMON"):
        monkeypatch.delenv(k, raising=False)
    assert launcher.main(["-1", "a", "b"]) == 7
    assert calls == [("req", ["-1", "a", "b"])]
    calls.clear()
    answer["rc"] = None
    assert launcher.main(["-1", "a", "b"]) == 0
    assert calls == [("req", ["-1", "a", "b"]), ("cli", ["-1", "a", "b"]),
                     ("spawn",)]
    for k, v in (("FQZ5_NO_DAEMON", "1"), ("FQZ5_DAEMON", "0")):
        calls.clear()
        monkeypatch.setenv(k, v)
        assert launcher.main(["-1", "a", "b"]) == 0
        assert calls == [("cli", ["-1", "a", "b"])]
        monkeypatch.delenv(k)
    for verb in (["--daemon-stop"], ["--daemon", "s"]):
        calls.clear()
        assert launcher.main(verb) == 0
        assert calls == [("cli", verb)]


def test_spawn_starts_a_detached_daemon(tmp_path, monkeypatch):
    sock = str(tmp_path / "s.sock")
    for k, v in _env(FQZ5_DAEMON_IDLE="60").items():
        monkeypatch.setenv(k, v)
    daemon.spawn(sock)
    deadline = time.monotonic() + START_S
    while not daemon.request(sock, None, op="ping"):
        assert time.monotonic() < deadline, "spawned daemon never answered"
        time.sleep(0.1)
    assert daemon.stop(sock)
    deadline = time.monotonic() + 30
    while os.path.exists(sock):
        assert time.monotonic() < deadline
        time.sleep(0.1)


def test_kernel_source_change_retires_the_server(tmp_path, data_dir):
    """A server on a copy of the package retires at its next job after a
    csrc/*.cu file of the copy changes: the job gets {"stale": true}, so
    the client runs it in-process (request returns None)."""
    copy = tmp_path / "pkg"
    shutil.copytree(os.path.join(ROOT, "fqzcomp5_tpu_torch"),
                    copy / "fqzcomp5_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    from fqzcomp5_tpu_torch.codecs import native

    sock = str(tmp_path / "t.sock")
    env = _env(PYTHONPATH=str(copy), FQZ5_NATIVE_LIB=native._LIB_PATH)
    p = _serve(sock, env, cwd=str(copy))
    try:
        sample = str(data_dir / "sample.fastq")
        arc = tmp_path / "a.fqz5"
        argv = ["-e", "host", "-1", "-V", sample, str(arc)]
        assert daemon.request(sock, argv) == 0
        cu = sorted((copy / "fqzcomp5_tpu_torch" / "csrc").glob("*.cu"))[0]
        st = cu.stat()
        os.utime(cu, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
        os.remove(arc)
        assert daemon.request(sock, argv) is None
        assert not arc.exists()
        p.wait(timeout=30)
        assert not os.path.exists(sock)
    finally:
        _stop(sock, p)


def test_default_socket_differs_from_the_jax_daemons(monkeypatch, tmp_path):
    monkeypatch.delenv("FQZ5_DAEMON", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ours = daemon.default_socket_path()
    assert ours != jdaemon.default_socket_path()
    assert os.path.dirname(ours) == str(tmp_path)
    assert "torch" in os.path.basename(ours)
    monkeypatch.setenv("FQZ5_DAEMON", str(tmp_path / "x.sock"))
    assert daemon.default_socket_path() == str(tmp_path / "x.sock")


_ENV_PROBE = ("import os, sys; sys.stdout.write(repr(("
              "os.environ.get('CUDA_VISIBLE_DEVICES'), "
              "os.environ.get('FQZ5_PROBE'), "
              "os.environ.get('FQZ5_SERVER_ONLY'))))")


def test_environment_forwarded(tmp_path, monkeypatch):
    """CUDA_VISIBLE_DEVICES and FQZ5_* reach the job as the client has
    them; a forwarded variable only the server has is unset in the
    job.  The job's argv is the probe's (cli.main replaced in the
    server before it forks)."""
    sock = str(tmp_path / "e.sock")
    serve = ("from fqzcomp5_tpu_torch import cli, daemon\n"
             "def main(argv):\n"
             "    exec(argv[0])\n"
             "    return 0\n"
             "cli.main = main\n"
             f"raise SystemExit(daemon.serve({sock!r}, quiet=True))\n")
    p = subprocess.Popen([sys.executable, "-c", serve],
                         env=_env(CUDA_VISIBLE_DEVICES="0",
                                  FQZ5_SERVER_ONLY="1"),
                         cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE)
    try:
        _wait_ping(sock, p)
        client = ("import sys\n"
                  "from fqzcomp5_tpu_torch import daemon\n"
                  "sys.exit(daemon.request(sys.argv[1], sys.argv[2:]))\n")
        r = subprocess.run(
            [sys.executable, "-c", client, sock, _ENV_PROBE],
            env=_env(CUDA_VISIBLE_DEVICES="3", FQZ5_PROBE="x"), cwd=ROOT,
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert r.stdout == repr(("3", "x", None))
    finally:
        _stop(sock, p)


def _nfds(pid):
    return len(os.listdir(f"/proc/{pid}/fd"))


def test_stalled_client_does_not_wedge_the_server(live, tmp_path):
    """A client that connects and sends nothing, or half a line, is
    dropped after RECV_TIMEOUT_S; pings meanwhile answer, and the fds of
    requests that are not jobs are closed."""
    sock, p = live
    stalled = []
    for payload in (b"", b'{"op": "pi'):
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(sock)
        if payload:
            c.sendall(payload)
        stalled.append(c)
    t0 = time.monotonic()
    assert daemon.request(sock, None, op="ping", timeout=30) is True
    assert time.monotonic() - t0 < 4 * daemon.RECV_TIMEOUT_S + 5
    for c in stalled:
        c.settimeout(10)
        assert c.recv(16) == b""   # the server closed it
        c.close()
    before = _nfds(p.pid)
    for _ in range(5):
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(sock)
            c.sendmsg([b'{"op": "ping"}\n'],
                      [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                        array.array("i", [0, 1, 2]).tobytes())])
            c.settimeout(10)
            assert json.loads(c.recv(64)) == {"ok": True}
    assert _nfds(p.pid) <= before


def test_lost_reply_after_delivery_fails_and_does_not_rerun(tmp_path,
                                                            data_dir):
    """A server that takes the job request and closes without a reply:
    request returns LOST_RC with ERROR:, and the launcher exits non-zero
    without running the job in-process."""
    sock = str(tmp_path / "lost.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(4)
    got = []

    def swallow():
        for _ in range(2):
            conn, _ = srv.accept()
            with conn:
                conn.settimeout(30)
                msg, anc, _f, _a = conn.recvmsg(1 << 16, 64)
                got.append(msg)
                for _lvl, _typ, data in anc:
                    a = array.array("i")
                    a.frombytes(data[:len(data) - len(data) % a.itemsize])
                    for fd in a:
                        os.close(fd)
    th = threading.Thread(target=swallow, daemon=True)
    th.start()
    try:
        arc = tmp_path / "o.fqz5"
        argv = ["-e", "host", "-1", str(data_dir / "sample.fastq"), str(arc)]
        assert daemon.request(sock, argv) == daemon.LOST_RC
        env = _env(FQZ5_DAEMON=sock)
        env.pop("FQZ5_NO_DAEMON")
        r = subprocess.run([sys.executable, "-m",
                            "fqzcomp5_tpu_torch.launcher", *argv], env=env,
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == daemon.LOST_RC != 0
        assert "ERROR:" in r.stderr and "gave no reply" in r.stderr
        assert not arc.exists()
        th.join(timeout=30)
        assert len(got) == 2 and all(b'"argv"' in m for m in got)
    finally:
        srv.close()


@pytest.mark.parametrize("client", ["request", "c"])
def test_client_death_cancels_the_job(tmp_path, data_dir, client):
    """A -e host -1 job reading the client's stdin, a pipe held open:
    SIGKILL on the client (daemon.request in a subprocess, or the C
    client) kills the job within 10 s, its output stops growing, and the
    server goes on serving."""
    sock = str(tmp_path / "d.sock")
    if client == "c":
        if shutil.which(os.environ.get("CC", "cc")) is None:
            pytest.skip("no C compiler")
        from tests.test_torch_client import client_tree

        cmd = [client_tree(str(tmp_path / "tree"))]
        env = _env(FQZ5_DAEMON=sock)
        env.pop("FQZ5_NO_DAEMON")
    else:
        cmd = [sys.executable, "-c", _CLIENT, sock]
        env = _env()
    p = _serve(sock)
    try:
        sample = (data_dir / "sample.fastq").read_bytes()
        out, err = tmp_path / "out.fqz5", tmp_path / "err"
        with open(out, "wb") as fo, open(err, "wb") as fe:
            cp = subprocess.Popen(cmd + ["-e", "host", "-1"],
                                  stdin=subprocess.PIPE, stdout=fo,
                                  stderr=fe, env=env, cwd=ROOT)
        try:
            cp.stdin.write(sample[:len(sample) // 2])
            cp.stdin.flush()
            deadline = time.monotonic() + 60
            while not (kids := torch_cases.job_children(p.pid)):
                assert cp.poll() is None, err.read_bytes()
                assert time.monotonic() < deadline, "the job never started"
                time.sleep(0.05)
            kid, = kids
            cp.kill()
            cp.wait(timeout=30)
            deadline = time.monotonic() + 10
            while os.path.exists(f"/proc/{kid}"):
                assert time.monotonic() < deadline, \
                    "the job outlived its client"
                time.sleep(0.05)
            size = out.stat().st_size
            time.sleep(0.5)
            assert out.stat().st_size == size
            assert torch_cases.job_children(p.pid) == []
        finally:
            if cp.poll() is None:
                cp.kill()
                cp.wait()
            try:
                cp.stdin.close()
            except BrokenPipeError:
                pass
        arc = tmp_path / "after.fqz5"
        argv = ["-e", "host", "-1", "-V", str(data_dir / "sample.fastq")]
        assert daemon.request(sock, argv + [str(arc)]) == 0
        assert arc.read_bytes() == _direct(tmp_path, argv, "direct.fqz5")
    finally:
        _stop(sock, p)