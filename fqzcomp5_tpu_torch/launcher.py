"""The port's command through its daemon:
``python -m fqzcomp5_tpu_torch.launcher ARGS``.

The counterpart of the JAX package's launcher routing: ARGS run through
a running port daemon (``daemon.request``; ``FQZ5_DAEMON=<path>`` picks
its socket) when one answers, else in-process through ``cli.main``,
after which a daemon is started in the background for the next call
(``daemon.spawn``), so that its warm-up never competes with the job.
``FQZ5_NO_DAEMON=1`` or ``FQZ5_DAEMON=0`` opts out: in-process, no
spawn.  The daemon verbs always run in-process.
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    use_daemon = (not os.environ.get("FQZ5_NO_DAEMON")
                  and os.environ.get("FQZ5_DAEMON", "") != "0"
                  and "--daemon" not in argv
                  and "--daemon-stop" not in argv)
    if use_daemon:
        from fqzcomp5_tpu_torch import daemon

        rc = daemon.request(None, argv)
        if rc is not None:
            return rc
    from fqzcomp5_tpu_torch.cli import main as cli_main

    rc = cli_main(argv)
    if use_daemon:
        daemon.spawn()
    return rc


if __name__ == "__main__":
    sys.exit(main())
