"""Optional observability: wandb scalar streaming + rich console status
(the port's copy of clid_slam_tpu/utils/observability.py).

Capability analog of the reference's logging surface
(utils/tools.py:161-169 wandb.init, slam.py:379-387 per-frame timing
scalars, utils/mapper.py:849-859 per-iteration losses,
utils/slam_dataset.py:759-767 final pose errors; rich console prints
gated by ``silence``, utils/config.py:334).

Both sinks are OPTIONAL and degrade to no-ops: wandb is not bundled in
this image (imported lazily, errors reported once), rich falls back to
plain prints. The logger is host-side only — it consumes the scalars the
pipelines already fetch, never forcing extra device readbacks (on the
streaming path call ``log_frame`` from ``sync()``-side code, not inside
the zero-readback loop).
"""

from __future__ import annotations

from typing import Optional


class MetricsLogger:
    """wandb (optional) + console sink for per-frame and final metrics."""

    def __init__(
        self,
        enabled: bool,
        run_name: str = "clid-slam-tpu",
        run_dir: Optional[str] = None,
        config: Optional[dict] = None,
        silence: bool = True,
        project: str = "CLID_SLAM_TPU",
    ):
        self.silence = silence
        self._wandb = None
        self._console = None
        if not silence:
            try:
                from rich.console import Console

                self._console = Console()
            except ImportError:
                pass
        if enabled:
            try:
                import wandb

                wandb.init(project=project, config=config or {}, dir=run_dir)
                wandb.run.name = run_name
                self._wandb = wandb
            except ImportError:
                self._print(
                    "[observability] wandb_vis_on is set but the optional "
                    "wandb package is not installed; continuing without it"
                )
            except Exception as e:  # offline, auth, ... — never fatal
                self._print(f"[observability] wandb disabled: {e}")

    def _print(self, msg: str):
        if self._console is not None:
            self._console.print(msg)
        elif not self.silence:
            print(msg)

    def log(self, scalars: dict):
        """Stream a dict of scalars (reference wandb_log_content shape)."""
        if self._wandb is not None:
            self._wandb.log(scalars)

    def log_frame(self, frame_id: int, timings: dict, losses: dict):
        """Per-frame timings + losses (slam.py:379-387 semantics)."""
        if self._wandb is not None:
            content = {"frame": frame_id}
            content.update(
                {f"timing(s)/{k}": float(v) for k, v in timings.items()}
            )
            content.update(
                {f"loss/{k}": float(v) for k, v in losses.items()}
            )
            self._wandb.log(content)
        if not self.silence:
            t = sum(float(v) for v in timings.values())
            loss_txt = " ".join(
                f"{k} {float(v):.4f}" for k, v in losses.items()
            )
            self._print(
                f"frame {frame_id}: {t*1e3:.1f} ms  {loss_txt}"
            )

    def log_final(self, metrics: dict):
        """Final pose-error metrics (utils/slam_dataset.py:759-767)."""
        if self._wandb is not None:
            self._wandb.log(
                {
                    f"final/{k}": float(v)
                    for k, v in metrics.items()
                    if isinstance(v, (int, float)) and v == v
                }
            )
        if not self.silence:
            self._print(f"final metrics: {metrics}")

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
