"""Trainer entry point: ``python -m jmt_tpu_torch.cli``.

Counterpart of ``jmt_tpu/cli.py``::

    python -m jmt_tpu_torch.cli --config config.json [--set K=V ...] \\
        [--synthetic N_VIDEOS:LENGTH[:IMG]] [--device cpu]
    python -m jmt_tpu_torch.cli --mode Eval --exp-dir exps/id_<exp_id> \\
        [--eval-weights auto|components|state] [--eval-split val|test]

Overrides take dotted paths and the reference's prefix forms, and any
unknown ``--key value`` flag is one, so a reference command line works
verbatim (``--opt__lr 0.0001``, ``--train_params__batch_size 32``,
``--l_audio_backbones wavLM+ResNet18``). ``--synthetic`` swaps in the
in-memory data source (train, val and test splits), so a run needs no
dataset on disk.

Training writes the experiment directory (``config.yml``,
``SavedWeights/`` with ``train_state.pt`` and the reference-layout
component ``.pt`` files, ``final_config.yml``, ``perfs.yml``,
``passed.txt``) and prints ``{"best": ...}``; a second run of a passed
experiment does nothing; ``--resume`` continues from ``train_state.pt``,
and a run that a preemption ended (``preempted.txt``) resumes without it.
Eval reloads ``final_config.yml`` and the weights (``components``: the
best epoch's; ``state``: the last epoch's) and prints the stitched valid
CCC, or writes the challenge ``{vid}.txt`` files.

The run is on the card unless ``--device cpu`` says otherwise; without a
card the default raises. ``--export-pt`` (the JAX package's conversion of
``.msgpack`` components) has no counterpart: the port writes
reference-format ``.pt`` components already.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

from jmt_tpu_torch.core.config import (Config, ExperimentDir,
                                       apply_overrides, read_yaml_or_json)
from jmt_tpu_torch.core.logging import init_logger


def _parse_value(v: str):
    try:
        return json.loads(v)
    except json.JSONDecodeError:
        return v


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="jmt_tpu_torch trainer")
    p.add_argument("--config", default=None,
                   help="JSON/YAML config file (config_file.json schema)")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override: dotted path or reference prefix form")
    p.add_argument("--synthetic", default=None, metavar="N:LEN[:IMG]",
                   help="use the synthetic data source (e.g. 2:481)")
    p.add_argument("--mode", "--Mode", default=None,
                   choices=["Training", "Eval"])
    p.add_argument("--exp-dir", "--fd_exp", default=None,
                   help="Eval mode: the experiment dir to reload")
    p.add_argument("--eval-split", "--eval_set", default="val",
                   choices=["val", "test"],
                   help="Eval mode: stitched validation, or the challenge "
                        "test files")
    p.add_argument("--resume", action="store_true",
                   help="Training mode: continue from train_state.pt")
    p.add_argument("--eval-weights", default="auto",
                   choices=["auto", "components", "state"],
                   help="Eval mode: 'components' loads the SavedWeights "
                        "component files (the best epoch), 'state' "
                        "train_state.pt (the last epoch); 'auto' prefers "
                        "components")
    p.add_argument("--weights-dir", default=None,
                   help="Eval mode: the directory of the weight files "
                        "(default <exp-dir>/SavedWeights)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    p.add_argument("--export-pt", default=None, metavar="WEIGHTS_DIR",
                   help="not needed here: the port writes reference .pt "
                        "components; the JAX package's command line "
                        "converts its .msgpack ones with --export-pt")
    args, extra = p.parse_known_args(argv)
    passthrough = []
    i = 0
    while i < len(extra):
        tok = extra[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unrecognized argument: {tok}")
        key = tok[2:]
        if "=" in key:
            passthrough.append(key)
            i += 1
        elif i + 1 < len(extra) and not extra[i + 1].startswith("--"):
            passthrough.append(f"{key}={extra[i + 1]}")
            i += 2
        else:
            raise SystemExit(f"flag {tok} needs a value")
    args.set = list(args.set) + passthrough
    return args


def build_config(args) -> Config:
    if args.mode == "Eval" and args.exp_dir:
        cfg = Config.from_file(os.path.join(args.exp_dir,
                                            "final_config.yml"))
        cfg.Mode = "Eval"
        return cfg
    raw: Dict = read_yaml_or_json(args.config) if args.config else {}
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = _parse_value(v)
    if args.mode:
        overrides["Mode"] = args.mode
    return Config.from_dict(apply_overrides(raw, overrides))


def make_datasets(cfg: Config, synthetic: str = None, **dataset_kw):
    """(train, val, test or None, wavLM store or None) of the config, or
    of the synthetic source ``N:LEN[:IMG]``. ``dataset_kw`` go to each
    ``WindowedDataset`` of a configured tree (a ``frame_loader``, a
    ``use_native``)."""
    if synthetic:
        from jmt_tpu_torch.data.synthetic import (synthetic_dataset,
                                                  synthetic_wavlm_store)
        parts = synthetic.split(":")
        n = int(parts[0])
        length = int(parts[1]) if len(parts) > 1 else 481
        img = int(parts[2]) if len(parts) > 2 else 112
        # no coverage check: smoke runs may use strides that leave anchor
        # gaps
        train, val, test = (
            synthetic_dataset(split, n_videos=n, length=length,
                              stride=getattr(cfg, f"{split}_params").stride,
                              img_size=img, check_coverage=False)
            for split in ("train", "val", "test"))
        return train, val, test, synthetic_wavlm_store()
    from jmt_tpu_torch.data.datasets import (WavlmFeatureStore,
                                             WindowedDataset,
                                             load_video_records)
    from jmt_tpu_torch.data.windowing import TRAIN_SKIP_VIDS
    cfg.auto_set_label_paths()
    if not (cfg.train_params.labelpath and cfg.dataset_wavspath):
        raise SystemExit(
            "no dataset configured: set dataset_annotations, "
            "dataset_rootpath, dataset_wavspath, dataset_realtimestamps "
            "(and wavlm_features for the wavLM backbone) in the config, or "
            "pass --synthetic N:LEN[:IMG] for a run without data")

    def records(params, **kw):
        return load_video_records(params.labelpath, cfg.dataset_wavspath,
                                  cfg.dataset_realtimestamps, **kw)

    def windowed(recs, split, params, **kw):
        return WindowedDataset(recs, split, stride=params.stride,
                               win_length=params.seq_length,
                               audio_samples=cfg.audio_samples, **kw,
                               **dataset_kw)

    train = windowed(records(cfg.train_params, skip=TRAIN_SKIP_VIDS,
                             take_n_videos=cfg.train_params.take_n_videos),
                     "train", cfg.train_params)
    val = windowed(records(cfg.val_params,
                           take_n_videos=cfg.val_params.take_n_videos),
                   "val", cfg.val_params)
    test = None
    if cfg.test_params.labelpath and os.path.isdir(cfg.test_params.labelpath):
        test = windowed(records(cfg.test_params), "test", cfg.test_params,
                        check_coverage=False)
    store = (WavlmFeatureStore(cfg.wavlm_features)
             if "wavLM" in cfg.model_params.l_audio_backbones else None)
    return train, val, test, store


def _has_components(wdir: str) -> bool:
    from jmt_tpu_torch.core.checkpoint import STATE_FILE
    return os.path.isdir(wdir) and any(
        f.endswith(".pt") and f != STATE_FILE for f in os.listdir(wdir))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.export_pt:
        raise SystemExit("--export-pt: the port's SavedWeights are "
                         "reference .pt files already; the JAX package's "
                         "command line converts its .msgpack components "
                         "with --export-pt DIR")
    cfg = build_config(args)
    exp = ExperimentDir(cfg)
    init_logger(exp.path if cfg.Mode == "Training" or args.exp_dir
                else None, stdout=cfg.verbose)
    from jmt_tpu_torch.train.runner import Runner
    train_ds, val_ds, test_ds, store = make_datasets(cfg, args.synthetic)
    runner = Runner(cfg, train_ds, val_ds, wavlm_store=store,
                    test_ds=test_ds, device=args.device)
    if cfg.Mode == "Training":
        # a run that graceful preemption ended resumes without --resume;
        # any other crash needs it
        from jmt_tpu_torch.core.checkpoint import STATE_FILE
        preempted_state = (cfg.graceful_preemption
                           and not exp.already_done()
                           and os.path.isfile(exp.preempted_marker)
                           and os.path.isfile(os.path.join(
                               exp.weights_dir, STATE_FILE)))
        if args.resume or preempted_state:
            runner.resume()
        perfs = runner.fit()
        print(json.dumps({"best": perfs.get("best", {})}, default=float))
        return 0
    runner.initialize()
    wdir = args.weights_dir or exp.weights_dir
    if args.eval_weights == "components" or (
            args.eval_weights == "auto" and _has_components(wdir)):
        runner.load_components(wdir)
    else:
        from jmt_tpu_torch.core.checkpoint import restore_train_state
        restore_train_state(wdir, runner.state)
    if args.eval_split == "test":
        out_dir = os.path.join(exp.path, "test_predictions")
        runner.test(out_dir, store_pkl=os.path.join(
            exp.path, "test-reevaluation.pkl"))
        print(json.dumps({"test_predictions_dir": out_dir}))
        return 0
    m = runner.validate(store_pkl=os.path.join(
        exp.path, "valid-reevaluation.pkl"))
    print(json.dumps({"valid_ccc_v": m.valid_ccc_v,
                      "valid_ccc_a": m.valid_ccc_a}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
