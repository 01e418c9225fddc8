"""The port's millisecond C client (native/client_torch.c, run through
bin/fqz5-torch) on the CPU against a live port daemon: every request is
-e host, as no card is visible.

The script and the client's source are copied into a tree under a
temporary directory, so the first run there builds the client into that
tree's build/fqz5_torch_client/ and the repository's own build/ is not
touched; the client then finds its Python fallback through PYTHONPATH.
Fake servers (a thread on a socket under tmp_path) stand in for a daemon
that answers {"stale": true}, one that takes the request and closes
without a reply, and one that only records what arrives.  Every wait has
a deadline, and no server outlives its test: FQZ5_DAEMON_IDLE bounds
any daemon a fallback spawns.  Skipped only where no C compiler is
found.
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
from fqzcomp5_tpu_torch import daemon
from tests.test_torch_daemon import ROOT, _direct, _env, _serve, _stop

CC = os.environ.get("CC", "cc")
pytestmark = pytest.mark.skipif(shutil.which(CC) is None,
                                reason=f"no C compiler ({CC})")
RUN_S = 120


def client_tree(dest) -> str:
    """bin/fqz5-torch and native/client_torch.c copied under dest; the
    script's path.  Its first run builds dest/build/fqz5_torch_client/."""
    os.makedirs(os.path.join(dest, "bin"), exist_ok=True)
    os.makedirs(os.path.join(dest, "native"), exist_ok=True)
    for rel in ("bin/fqz5-torch", "native/client_torch.c"):
        shutil.copy2(os.path.join(ROOT, rel), os.path.join(dest, rel))
    return os.path.join(dest, "bin", "fqz5-torch")


def _cenv(sock=None, **extra):
    """A client's environment: the daemon's socket, no opt-out, and a
    short idle limit for any daemon a fallback spawns."""
    env = _env(FQZ5_DAEMON_IDLE="20", **extra)
    env.pop("FQZ5_NO_DAEMON")
    if sock is not None:
        env["FQZ5_DAEMON"] = sock
    return env


def _run(script, args, env, **kw):
    return subprocess.run([script, *args], env=env, cwd=kw.pop("cwd", ROOT),
                          capture_output=True, timeout=RUN_S, **kw)


@pytest.fixture(scope="module")
def script(tmp_path_factory):
    return client_tree(str(tmp_path_factory.mktemp("client")))


@pytest.fixture()
def live(tmp_path):
    sock = str(tmp_path / "d.sock")
    p = _serve(sock)
    yield sock, p
    _stop(sock, p)


class FakeServer:
    """A socket under tmp_path whose thread answers each connection with
    reply(request) (None: close without a reply) and records every
    request; the fds that arrive are closed."""

    def __init__(self, path, reply):
        self.path, self.reply, self.got = path, reply, []
        self.srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.srv.bind(path)
        self.srv.listen(8)
        self.srv.settimeout(0.2)
        self.done = False
        self.th = threading.Thread(target=self._loop, daemon=True)
        self.th.start()

    def _loop(self):
        while not self.done:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                continue
            with conn:
                conn.settimeout(30)
                buf = b""
                while b"\n" not in buf:
                    msg, anc, _f, _a = conn.recvmsg(1 << 16, 64)
                    for _lvl, _typ, data in anc:
                        a = array.array("i")
                        a.frombytes(data[:len(data) - len(data) % a.itemsize])
                        for fd in a:
                            os.close(fd)
                    if not msg:
                        break
                    buf += msg
                req = json.loads(buf.split(b"\n", 1)[0])
                self.got.append(req)
                rep = self.reply(req)
                if rep is not None:
                    conn.sendall(json.dumps(rep).encode() + b"\n")

    def jobs(self):
        return [r for r in self.got if "argv" in r]

    def close(self):
        self.done = True
        self.th.join(timeout=30)
        self.srv.close()


def test_builds_at_first_use_and_when_the_source_is_newer(tmp_path,
                                                          data_dir):
    """The first run builds the client into the tree's build/; a newer
    source rebuilds it; without a compiler the script says so on stderr
    and runs the Python launcher, with the same archive."""
    script = client_tree(str(tmp_path / "tree"))
    exe = tmp_path / "tree" / "build" / "fqz5_torch_client" / "fqz5-torch"
    sample = str(data_dir / "sample.fastq")
    want = _direct(tmp_path, ["-e", "host", "-1", "-V", sample], "d.fqz5")
    env = _env()   # FQZ5_NO_DAEMON=1: the launcher, in-process
    r = _run(script, ["-e", "host", "-1", "-V", sample,
                      str(tmp_path / "a.fqz5")], env)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "a.fqz5").read_bytes() == want
    assert os.access(exe, os.X_OK)
    built = exe.stat().st_mtime_ns
    src = tmp_path / "tree" / "native" / "client_torch.c"
    os.utime(src, ns=(built + 10**9, built + 10**9))
    r = _run(script, ["-e", "host", "-1", "-V", sample,
                      str(tmp_path / "b.fqz5")], env)
    assert r.returncode == 0, r.stderr
    assert exe.stat().st_mtime_ns > built
    assert r.stderr == b""
    exe.unlink()
    r = _run(script, ["-e", "host", "-1", "-V", sample,
                      str(tmp_path / "c.fqz5")], dict(env, CC="false"))
    assert r.returncode == 0, r.stderr
    assert r.stderr.decode().count("\n") == 1
    assert b"warning: cannot build" in r.stderr
    assert (tmp_path / "c.fqz5").read_bytes() == want
    assert not exe.exists()


def test_archive_through_the_client_equals_a_direct_run(script, live,
                                                        tmp_path, data_dir):
    """-1 and -5 archives through the daemon equal direct runs and decode
    to the source; a file name that is not UTF-8 reaches the job as a
    direct run sees it."""
    sock, _ = live
    sample = str(data_dir / "sample.fastq")
    for lvl in ("-1", "-5"):
        arc = tmp_path / f"c{lvl}.fqz5"
        r = _run(script, ["-e", "host", lvl, "-V", sample, str(arc)],
                 _cenv(sock))
        assert r.returncode == 0, r.stderr
        assert arc.read_bytes() == _direct(
            tmp_path, ["-e", "host", lvl, "-V", sample], f"p{lvl}.fqz5")
        out = tmp_path / f"rt{lvl}.fastq"
        r = _run(script, ["-e", "host", "-d", "-V", str(arc), str(out)],
                 _cenv(sock))
        assert r.returncode == 0, r.stderr
        assert out.read_bytes() == open(sample, "rb").read()
    odd = os.path.join(os.fsencode(tmp_path), b"q\xff\"\\.fqz5")
    r = subprocess.run([script, "-e", "host", "-1", "-V", sample, odd],
                       env=_cenv(sock), cwd=ROOT, capture_output=True,
                       timeout=RUN_S)
    assert r.returncode == 0, r.stderr
    with open(odd, "rb") as fp:
        assert fp.read() == (tmp_path / "c-1.fqz5").read_bytes()


def test_stdin_stdout_pipes_and_relative_paths(script, live, tmp_path,
                                               data_dir):
    """An encode from stdin to stdout, a decode to stdout and -v's report
    on stderr, all through the client's fds; a relative output path is
    taken from the client's cwd."""
    sock, _ = live
    sample = data_dir / "sample.fastq"
    r = _run(script, ["-e", "host", "-1", "-v"], _cenv(sock),
             input=sample.read_bytes())
    assert r.returncode == 0, r.stderr
    assert b"blocks combined" in r.stderr
    (tmp_path / "s.fqz5").write_bytes(r.stdout)
    r = _run(script, ["-e", "host", "-d", "s.fqz5"], _cenv(sock),
             cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout == sample.read_bytes()


def test_exit_codes_relayed(script, live, tmp_path, data_dir):
    """A bad input gives 1 and ERROR: as a direct run does; the server
    goes on serving."""
    sock, _ = live
    sample = str(data_dir / "sample.fastq")
    for args in (["-e", "host", "-1", str(tmp_path / "no.fq"),
                  str(tmp_path / "o.fqz5")],
                 ["-e", "host", "-d", sample, str(tmp_path / "x")]):
        r = _run(script, args, _cenv(sock))
        assert r.returncode == 1
        assert r.stderr.startswith(b"ERROR:"), r.stderr
        assert b"Traceback" not in r.stderr
    assert daemon.request(sock, None, op="ping") is True


def test_fallback_without_a_daemon(script, tmp_path, data_dir):
    """No daemon on the socket: the launcher runs the job and spawns a
    daemon there, which the next call uses.  With FQZ5_NO_DAEMON=1 (or
    FQZ5_DAEMON=0) the job runs in-process and nothing is spawned."""
    sample = str(data_dir / "sample.fastq")
    want = _direct(tmp_path, ["-e", "host", "-1", "-V", sample], "d.fqz5")
    sock = str(tmp_path / "f.sock")
    for k, v in (("FQZ5_NO_DAEMON", "1"), ("FQZ5_DAEMON", "0")):
        env = _cenv(sock)
        env[k] = v
        arc = tmp_path / f"{k}.fqz5"
        r = _run(script, ["-e", "host", "-1", "-V", sample, str(arc)], env)
        assert r.returncode == 0, r.stderr
        assert arc.read_bytes() == want
    time.sleep(1)
    assert not os.path.exists(sock)
    arc = tmp_path / "spawn.fqz5"
    r = _run(script, ["-e", "host", "-1", "-V", sample, str(arc)],
             _cenv(sock))
    assert r.returncode == 0, r.stderr
    assert arc.read_bytes() == want
    try:
        deadline = time.monotonic() + 90
        while not daemon.request(sock, None, op="ping"):
            assert time.monotonic() < deadline, "no daemon was spawned"
            time.sleep(0.1)
        os.remove(arc)
        r = _run(script, ["-e", "host", "-1", "-V", sample, str(arc)],
                 _cenv(sock))
        assert r.returncode == 0, r.stderr
        assert arc.read_bytes() == want
    finally:
        daemon.stop(sock)
    deadline = time.monotonic() + 30
    while os.path.exists(sock):
        assert time.monotonic() < deadline
        time.sleep(0.1)


def test_control_verbs_go_to_python(script, tmp_path):
    """--daemon-stop runs in Python (the verb sends {"op": "stop"}; the
    client never sends it as a job), and stops a live daemon."""
    fake = FakeServer(str(tmp_path / "v.sock"), lambda req: {"ok": True})
    try:
        r = _run(script, ["--daemon-stop", fake.path], _cenv(fake.path))
        assert r.returncode == 0, r.stderr
        assert fake.got == [{"op": "stop"}]
    finally:
        fake.close()
    sock = str(tmp_path / "w.sock")
    p = _serve(sock)
    try:
        r = _run(script, ["--daemon-stop", sock], _cenv())
        assert r.returncode == 0, r.stderr
        p.wait(timeout=30)
    finally:
        _stop(sock, p)


def test_stale_reply_falls_back(script, tmp_path, data_dir):
    """A {"stale": true} reply: the job did not run, so the client hands
    it to the launcher, which asks once more and then runs it
    in-process.  The daemon it spawns finds the fake one answering ping
    and exits."""
    fake = FakeServer(str(tmp_path / "st.sock"),
                      lambda req: {"ok": True} if "op" in req
                      else {"stale": True})
    sample = str(data_dir / "sample.fastq")
    arc = tmp_path / "s.fqz5"
    try:
        r = _run(script, ["-e", "host", "-1", "-V", sample, str(arc)],
                 _cenv(fake.path))
        assert r.returncode == 0, r.stderr
        assert arc.read_bytes() == _direct(
            tmp_path, ["-e", "host", "-1", "-V", sample], "d.fqz5")
        assert len(fake.jobs()) == 2
        deadline = time.monotonic() + 90
        while {"op": "ping"} not in fake.got:
            assert time.monotonic() < deadline, "no ping from a spawned one"
            time.sleep(0.1)
    finally:
        fake.close()


_ENV_PROBE = ("import os, sys; sys.stdout.write(repr(("
              "os.environ.get('CUDA_VISIBLE_DEVICES'), "
              "os.environ.get('FQZ5_PROBE'), "
              "os.environ.get('FQZ5_SERVER_ONLY'), "
              "os.environ.get('TMPDIR'), "
              "os.environ.get('FQZ5_DAEMON'))))")


def test_environment_forwarded(script, tmp_path):
    """FQZ5_* (but FQZ5_DAEMON), TMPDIR and CUDA_VISIBLE_DEVICES reach
    the job as the client has them; a forwarded variable only the server
    has is unset in the job.  The job's argv is the probe's (cli.main
    replaced in the server before it forks)."""
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
        from tests.test_torch_daemon import _wait_ping

        _wait_ping(sock, p)
        r = _run(script, [_ENV_PROBE],
                 _cenv(sock, CUDA_VISIBLE_DEVICES="3", FQZ5_PROBE="x",
                       TMPDIR=str(tmp_path)))
        assert r.returncode == 0, r.stderr
        assert r.stdout.decode() == repr(("3", "x", None, str(tmp_path),
                                          None))
    finally:
        _stop(sock, p)


def test_default_socket_is_the_ports(script, tmp_path):
    """Without FQZ5_DAEMON the client connects to
    $TMPDIR/fqz5-torch-daemon-$UID.sock, daemon.default_socket_path's,
    which is not the JAX client's socket."""
    env = _cenv(TMPDIR=str(tmp_path))
    ours = os.path.join(str(tmp_path),
                        f"fqz5-torch-daemon-{os.getuid()}.sock")
    old = os.environ.get("TMPDIR")
    os.environ["TMPDIR"] = str(tmp_path)
    try:
        os.environ.pop("FQZ5_DAEMON", None)
        assert daemon.default_socket_path() == ours
        assert jdaemon.default_socket_path() != ours
    finally:
        if old is None:
            del os.environ["TMPDIR"]
        else:
            os.environ["TMPDIR"] = old
    fake = FakeServer(ours, lambda req: {"rc": 5})
    try:
        r = _run(script, ["-e", "host", "-1", "x"], env, umask=0o027)
        assert r.returncode == 5, r.stderr
        job, = fake.jobs()
        assert job["argv"] == ["-e", "host", "-1", "x"]
        assert job["cwd"] == ROOT and job["umask"] == 0o027
    finally:
        fake.close()


def test_lost_reply_after_delivery_fails_and_does_not_rerun(script,
                                                            tmp_path,
                                                            data_dir):
    """A server that takes the job and closes without a reply: exit 1
    with ERROR: on stderr, and the job is not run again (in-process or
    through a second request)."""
    fake = FakeServer(str(tmp_path / "lost.sock"), lambda req: None)
    arc = tmp_path / "o.fqz5"
    try:
        r = _run(script, ["-e", "host", "-1", str(data_dir / "sample.fastq"),
                          str(arc)], _cenv(fake.path))
        assert r.returncode == daemon.LOST_RC == 1
        assert r.stderr.startswith(b"ERROR:"), r.stderr
        assert b"the job may have run" in r.stderr
        assert not arc.exists()
        assert len(fake.got) == 1 and len(fake.jobs()) == 1
    finally:
        fake.close()
