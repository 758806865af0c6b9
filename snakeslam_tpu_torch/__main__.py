"""CLI entry point: ``python -m snakeslam_tpu_torch <config.ini> [options]``.

Counterpart of ``snakeslam_tpu/__main__.py``, mirroring the reference's
``snake_slam <config.ini> [--dataset --name --outDir]`` (reference:
Snake/main.cpp:29-44): load settings (with write-back of missing defaults
into the INI file), apply per-dataset presets and CLI overrides, run the
system over the dataset on ``--device`` (default ``cuda``: the card; a run
without one exits non-zero unless ``--device cpu`` is asked for), write
TUM trajectories, a PLY / npz map snapshot and, where matplotlib is
installed, a map plot, and print the statistics tables: the tracer's
spans of the run (``system/stats.py``: calls, mean and self ms per span
name, and its counters) and the map's statistics.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path


def _profiler(trace_dir: Path, device):
    """A torch.profiler context that writes a Chrome trace of the run into
    ``trace_dir`` (CPU activity, and CUDA activity on a card)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def cm():
        trace_dir.mkdir(parents=True, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(str(trace_dir / "trace.json"))

    return cm()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="snakeslam_tpu_torch")
    ap.add_argument("config", help="INI config file (created if missing; "
                                   "missing keys are written back into it)")
    ap.add_argument("--dataset", default=None, help="dataset directory")
    ap.add_argument("--name", default=None, help="output file prefix")
    ap.add_argument("--outDir", default=None, help="evaluation output dir")
    ap.add_argument("--maxFrames", type=int, default=None)
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler Chrome trace of the run "
                         "into <outDir>/trace")
    ap.add_argument("--overlayEvery", type=int, default=0,
                    help="export a feature-overlay PNG every N tracked "
                         "frames into <outDir>/frames (the headless "
                         "viewer-frame stream; 0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device found: run on a card, or pass --device cpu",
              file=sys.stderr)
        return 2

    from snakeslam_tpu_torch.frontend.input import Input
    from snakeslam_tpu_torch.system import stats as tracer
    from snakeslam_tpu_torch.system.settings import Settings
    from snakeslam_tpu_torch.system.slam import SlamSystem
    from snakeslam_tpu_torch.viewer.export import (FrameOverlayWriter,
                                                   export_viewer_snapshot)

    settings = Settings.from_ini(args.config)
    settings.set_default_parameters_for_dataset()
    if args.dataset:
        settings.dataset.dataset_dir = args.dataset
    if args.name:
        settings.out_file_prefix = args.name
    if args.outDir:
        settings.eval_dir = args.outDir
    if args.maxFrames is not None:
        settings.dataset.max_frames = args.maxFrames
    if not settings.dataset.dataset_dir:
        print("no dataset directory configured", file=sys.stderr)
        return 2

    inp = Input(settings, dataset_root=settings.dataset.dataset_dir,
                device=device)
    system = SlamSystem(settings, device)
    if args.overlayEvery > 0:
        writer = FrameOverlayWriter(
            Path(settings.eval_dir) / "frames", every_n=args.overlayEvery,
            size=(settings.width, settings.height))
        system.frame_listeners.append(writer.on_frame)
    profile_cm = (_profiler(Path(settings.eval_dir) / "trace", device)
                  if args.profile else contextlib.nullcontext())
    tracer.reset()
    tracer.enable()
    try:
        with profile_cm:
            wall = system.run(iter(inp))
    finally:
        tracer.disable()

    out_dir = Path(settings.eval_dir)
    system.write_trajectories(out_dir)
    export_viewer_snapshot(system.map, out_dir, tag=settings.out_file_prefix)
    try:
        from snakeslam_tpu_torch.viewer.plot import plot_map

        plot_map(system.map,
                 out_dir / f"{settings.out_file_prefix}_map.png",
                 trajectory=system.tracker.trajectory,
                 title=settings.out_file_prefix)
    except Exception as e:  # matplotlib optional
        print(f"map plot skipped: {e}", file=sys.stderr)
    n = len(system.tracker.trajectory)
    print(f"tracked {n} frames in {wall:.1f}s "
          f"({n / max(wall, 1e-9):.1f} fps)")
    print(f"keyframes: {system.map.n_keyframes}  "
          f"points: {system.map.n_points}")
    print(tracer.table())
    print(system.map_statistics())
    return 0


if __name__ == "__main__":
    sys.exit(main())
