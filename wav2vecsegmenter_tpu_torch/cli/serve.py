"""Segmentation serving daemon.

Counterpart of ``wav2vecsegmenter_tpu/cli/serve.py``, with its override
surface (the repo's ``conf/serve.yaml``, the training run's config merged
underneath).  Listens on TCP (``host``/``port``) or a unix socket
(``unix_path``) and serves live PCM connections through one batched engine
(``infer/server.SegmentationServer`` over ``MultiStreamSegmenter``; the
wire protocol is in its docstring):

    python -m wav2vecsegmenter_tpu_torch.cli.serve ckpt_path=... \\
        config_path=... algorithm=pthr port=7957 [runtime.precision=f32res] \\
        [runtime.quantize=int8]

The bound address prints as one JSON line, ``{"type": "listening",
"address": ...}``; SIGTERM or SIGINT drains every active stream before the
daemon exits.  The engine runs on the first CUDA device and raises without
one; ``+runtime.device=cpu`` asks for the CPU.  ``-m`` is refused;
``runtime.profile_steps`` is accepted and does nothing, as in the JAX CLI
(ROADMAP C22).  pyyaml is imported inside :func:`main` only.
"""

from __future__ import annotations

import json
import signal

from ..infer.server import SegmentationServer
from . import common
from .online import build_engine
from .segment import CONF_DIR


def build_server(config) -> SegmentationServer:
    """The engine from the config and the bound listening socket (not
    serving yet: callers run ``serve_forever``)."""
    engine, seg_kwargs = build_engine(config)
    return SegmentationServer(
        engine,
        host=str(config.get("host", "127.0.0.1")),
        port=int(config.get("port", 0)),
        unix_path=config.get("unix_path") or None,
        max_batch=int(config.get("max_batch", 8)),
        stats_every_s=float(config.get("stats_every_s", 60.0)),
        max_conns=int(config.get("max_conns", 0)),
        **seg_kwargs,
    )


def main(argv: list[str] | None = None):
    from ..config import load_config, merge

    multirun, jobs = common.cli_jobs(CONF_DIR, "serve", argv)
    if multirun:
        raise ValueError("the serve CLI does not support -m multirun")
    (config, _), = jobs
    if config.get("config_path"):
        config = merge(load_config(config.config_path), config)
    common.init_logging()

    server = build_server(config)
    # a machine-readable bind line, so that wrappers find an ephemeral port
    print(json.dumps({"type": "listening", "address": server.address}),
          flush=True)
    common.logger.info("serving on %s", server.address)

    # SIGTERM/SIGINT stop the loop; serve_forever then drains every active
    # stream (tail flush + end line) before closing
    def _stop(signum, frame):
        common.logger.info("signal %d: draining active streams", signum)
        server.shutdown()

    try:
        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
    except ValueError:
        pass  # not the main thread (embedded use): rely on shutdown()
    try:
        server.serve_forever()  # drains and closes however it ends
    except KeyboardInterrupt:
        common.logger.info("shutting down")


if __name__ == "__main__":
    main()
