"""The port runs without JAX and without the JAX package, and only
`-e host` runs on the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent("""
    import io, sys
    import numpy as np
    import torch
    import fqzcomp5_tpu_torch
    from fqzcomp5_tpu_torch import cli, cuda_driver
    rng = np.random.default_rng(1)
    recs = []
    for i in range(300):
        s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 80))
        q = bytes((rng.normal(30, 4, 80).clip(0, 40) + 33).astype(np.uint8))
        recs.append(b"@r%d\\n" % i + s + b"\\n+\\n" + q + b"\\n")
    path = sys.argv[1]
    open(path, "wb").write(b"".join(recs))
    from fqzcomp5_tpu_torch.drivers import make_fastq_writer
    cpu = torch.device("cpu")
    for preset in ("-3", "-5"):
        arg, _, _ = cli.parse_args([preset, "-V"])
        comp = io.BytesIO()
        cuda_driver.encode_file(path, comp, arg, cuda_driver.Timings(), cpu)
        # both table forms of the rANS decode walks (FQZ5_DEC_V3)
        for tables in ("lut", "boundary"):
            comp.seek(0)
            out = io.BytesIO()
            cuda_driver.decode_file(comp, make_fastq_writer(out, arg), arg,
                                    cuda_driver.Timings(), cpu,
                                    tables=tables)
            assert out.getvalue() == b"".join(recs)
    # -e host: the host engine on the CPU, through the port's CLI
    for argv in (["-e", "host", "-3", "-V", path, path + ".fqz5"],
                 ["-e", "host", "-d", "-V", path + ".fqz5", path + ".out"]):
        assert cli.main(argv) == 0
    assert open(path + ".out", "rb").read() == b"".join(recs)
    for pkg in ("jax", "fqzcomp5_tpu"):
        loaded = [m for m in sys.modules
                  if m == pkg or m.startswith(pkg + ".")]
        print("MODULES", pkg, loaded)
""")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_never_imports_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", _SCRIPT,
                        str(tmp_path / "in.fastq")],
                       capture_output=True, text=True, env=_env(), cwd=ROOT,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "MODULES jax []" in r.stdout
    assert "MODULES fqzcomp5_tpu []" in r.stdout


_RANK = textwrap.dedent("""
    import sys
    from fqzcomp5_tpu_torch.parallel import distributed
    rc = distributed.main(sys.argv[1:])
    for pkg in ("jax", "fqzcomp5_tpu"):
        loaded = [m for m in sys.modules
                  if m == pkg or m.startswith(pkg + ".")]
        print("MODULES", pkg, loaded)
    sys.exit(rc)
""")


def test_distributed_ranks_never_import_jax(tmp_path):
    """Two ranks of the distributed entry, each on a local mesh of two
    CPU slots, encode and then decode without importing either."""
    from tests.test_torch_distributed import check_ok, make_fastq, run_ranks

    src = tmp_path / "in.fastq"
    data = make_fastq(src, n=400)
    comp, out = tmp_path / "c.fqz5", tmp_path / "o.fastq"
    for args in (["-1", "-b", 8 << 10, "--device", "cpu", src, comp],
                 ["-d", comp, out]):
        outs = run_ranks(2, args, env={"FQZ5_DIST_LOCAL_MESH": "1x2"},
                         entry=["-c", _RANK])
        check_ok(outs)
        for _rc, stdout, _err in outs:
            assert "MODULES jax []" in stdout
            assert "MODULES fqzcomp5_tpu []" in stdout
    assert out.read_bytes() == data


def _modules(path):
    """Names of the modules a source file imports (absolute imports)."""
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def _imports(path):
    """Top-level package names of the modules a source file imports."""
    return {n.split(".")[0] for n in _modules(path)}


def test_port_sources_never_import_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_cases.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "fqzcomp5_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for name in ("pipeline", "distributed", "dist_cuda"):
        assert os.path.join(ROOT, "fqzcomp5_tpu_torch", "parallel",
                            name + ".py") in files
    for name in ("daemon", "launcher"):
        assert os.path.join(ROOT, "fqzcomp5_tpu_torch", name + ".py") in files
    bad = {f: _imports(f) & {"fqzcomp5_tpu", "jax"} for f in files}
    assert not {f: b for f, b in bad.items() if b}


def _fastq(tmp_path):
    rng = np.random.default_rng(2)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 50)])
    src = tmp_path / "in.fastq"
    src.write_text("".join(f"@r{i}\n{seq}\n+\n{'I' * 50}\n"
                           for i in range(20)))
    return src


def test_cuda_engine_without_gpu_fails_and_writes_nothing(tmp_path):
    src = _fastq(tmp_path)
    for argv, msg in ((["-e", "cuda", "-1"], "needs a CUDA device"),
                      (["-e", "cuda", "-5"], "needs a CUDA device"),
                      (["-1"], "needs a CUDA device"),
                      (["-e", "tpu"], "JAX package's engine")):
        comp = tmp_path / "c.fqz5"
        r = subprocess.run(
            [sys.executable, "-m", "fqzcomp5_tpu_torch.cli",
             *argv, str(src), str(comp)],
            capture_output=True, text=True, env=_env(), cwd=ROOT,
            timeout=120)
        assert r.returncode == 1
        assert r.stderr.startswith("ERROR:") and msg in r.stderr
        assert "Traceback" not in r.stderr
        assert not comp.exists()


def test_kernel_layer_never_imports_the_scale_out_layer():
    """The kernels, the engine and its driver take a mesh from the leaf
    module fqzcomp5_tpu_torch.mesh (torch only); parallel/ imports them,
    never the other way round."""
    pkg = os.path.join(ROOT, "fqzcomp5_tpu_torch")
    files = [os.path.join(pkg, n)
             for n in ("mesh.py", "engine_cuda.py", "cuda_driver.py")]
    files += [os.path.join(pkg, "ops", n)
              for n in sorted(os.listdir(os.path.join(pkg, "ops")))
              if n.endswith(".py")]
    assert len(files) > 15
    bad = {f: [m for m in _modules(f)
               if m.startswith("fqzcomp5_tpu_torch.parallel")]
           for f in files}
    assert not {f: b for f, b in bad.items() if b}
    assert _modules(os.path.join(pkg, "mesh.py")) <= {"__future__", "torch"}


_PRELOAD = textwrap.dedent("""
    import sys
    import torch
    from fqzcomp5_tpu_torch import daemon
    daemon._preload()
    for pkg in ("jax", "fqzcomp5_tpu"):
        loaded = [m for m in sys.modules
                  if m == pkg or m.startswith(pkg + ".")]
        print("MODULES", pkg, loaded)
    print("CUDA_INITIALIZED", torch.cuda.is_initialized())
    print("CLI", "fqzcomp5_tpu_torch.cuda_driver" in sys.modules)
""")


def test_daemon_preload_imports_no_jax_and_leaves_cuda_alone():
    """The daemon's server preloads the port without the JAX package and
    without initialising CUDA, which a forked child could not use."""
    r = subprocess.run([sys.executable, "-c", _PRELOAD], capture_output=True,
                       text=True, env=_env(), cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "MODULES jax []" in r.stdout
    assert "MODULES fqzcomp5_tpu []" in r.stdout
    assert "CUDA_INITIALIZED False" in r.stdout
    assert "CLI True" in r.stdout
