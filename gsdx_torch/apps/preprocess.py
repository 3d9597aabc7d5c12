"""Preprocessing CLI (counterpart of `gsdx/apps/preprocess.py`).

For every tracked episode of the config's dataset, writes the unit-push
frame pairs and the downsampled trajectories that `apps/train.py` reads.
The dataset's `base_dir` is taken relative to the working directory:

    <base>/data/<name>/episode_XX/             actions.txt, calibration
    <base>/ckpts/exp_<name>/episode_XX/<name>/episode_XX/
                                               params.npz, metadata.json
                                               (+ param_downsampled.npy)
    <base>/preprocessed/exp_<name>/episode_XX/ frame_pairs/XX.txt, metadata.txt

    python -m gsdx_torch.apps.preprocess --config configs/rope.yaml
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gsdx_torch.core.device import require_device
    from gsdx_torch.io.config import parse_yaml
    from gsdx_torch.io.preprocess import preprocess_episode

    device = require_device(args.device)
    with open(args.config) as f:
        raw = parse_yaml(f.read())
    ds = raw["dataset_config"]["datasets"][0]
    tc = raw["train_config"]

    base, name = Path(ds["base_dir"]), ds["name"]
    data_dir = base / "data" / name
    output_dir = base / "ckpts" / f"exp_{name}"
    prep_dir = base / "preprocessed" / f"exp_{name}"

    episodes = sorted(glob.glob(str(output_dir / "episode_*")))
    episode_idxs = [int(e.split("_")[-1]) for e in episodes]
    n_ok = 0
    for idx in episode_idxs:
        ep = f"episode_{idx:02d}"
        epi_out = output_dir / ep / name / ep
        if not (epi_out / "params.npz").exists():
            continue
        try:
            rows = preprocess_episode(
                str(data_dir / ep), str(epi_out), str(prep_dir / ep),
                dist_thresh=tc.get("dist_thresh", 0.01), n_his=tc["n_his"],
                n_future=tc["n_future"], episode_idx=idx, device=device)
        except ValueError as e:
            print(f"episode {idx} failed: {e}")
            continue
        if rows is None:
            print(f"episode {idx} invalid")
            continue
        print(f"episode {idx}: {len(rows)} unit pushes")
        n_ok += 1
    print(f"preprocessed {n_ok}/{len(episode_idxs)} episodes")


if __name__ == "__main__":
    main()
