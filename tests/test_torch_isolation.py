"""The port runs without JAX, and `-e cuda` never runs on the CPU."""

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
    from fqzcomp5_tpu.drivers import make_fastq_writer
    cpu = torch.device("cpu")
    for preset in ("-3", "-5"):
        arg, _, _ = cli.parse_args([preset, "-V"])
        comp, out = io.BytesIO(), io.BytesIO()
        cuda_driver.encode_file(path, comp, arg, cuda_driver.Timings(), cpu)
        comp.seek(0)
        cuda_driver.decode_file(comp, make_fastq_writer(out, arg), arg,
                                cuda_driver.Timings(), cpu)
        assert out.getvalue() == b"".join(recs)
    loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    print("JAX_MODULES", loaded)
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
    assert "JAX_MODULES []" in r.stdout


def _fastq(tmp_path):
    rng = np.random.default_rng(2)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 50)])
    src = tmp_path / "in.fastq"
    src.write_text("".join(f"@r{i}\n{seq}\n+\n{'I' * 50}\n"
                           for i in range(20)))
    return src


def test_cuda_engine_without_gpu_fails_and_writes_nothing(tmp_path):
    src = _fastq(tmp_path)
    for argv, msg in ((["-1"], "needs a CUDA device"),
                      (["-5"], "needs a CUDA device")):
        comp = tmp_path / "c.fqz5"
        r = subprocess.run(
            [sys.executable, "-m", "fqzcomp5_tpu_torch.cli", "-e", "cuda",
             *argv, str(src), str(comp)],
            capture_output=True, text=True, env=_env(), cwd=ROOT,
            timeout=120)
        assert r.returncode == 1
        assert r.stderr.startswith("ERROR:") and msg in r.stderr
        assert "Traceback" not in r.stderr
        assert not comp.exists()
