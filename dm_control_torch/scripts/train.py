"""The behaviour-cloning training command (counterpart of
``dm_control_tpu/scripts/train.py``; reference:
dm_control/scripts/train.py:13-95).  The model trains on ``--device``, the
card by default:

    python -m dm_control_torch.scripts.train --dataset=data.hdf5 \
        --model=gpt --block_size=4 --max_epochs=10
    python -m dm_control_torch.scripts.train --dataset=data.hdf5 \
        --model=ffnet --max_epochs=1 --device=cpu

The flags and their defaults are the JAX command's, which differ from
``TrainerConfig``'s: ``--learning_rate`` 1e-4 (3e-4) and
``--grad_norm_clip`` 5.0 (1.0).
"""

from __future__ import annotations

import argparse


def _list(s):
    return [x for x in s.split(",") if x]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add = parser.add_argument
    add("--checkpoint_path", default="saved_model.pt",
        help="Path to save model checkpoints")
    add("--config_path", default="saved_model_config.json",
        help="Path to save model config")
    add("--dataset", default="trajectory_dataset.hdf5", help="Dataset path.")
    add("--test_dataset", default="", help="Optional held-out dataset path.")
    add("--max_epochs", type=int, default=10, help="Maximum training epochs.")
    add("--batch_size", type=int, default=64, help="Batch size.")
    add("--learning_rate", type=float, default=1e-4, help="Learning rate")
    add("--grad_norm_clip", type=float, default=5.0, help="Clip gradient norm")
    add("--block_size", type=int, default=4, help="History/context length.")
    add("--gpt_layers", type=int, default=8, help="GPT layers")
    add("--gpt_heads", type=int, default=8, help="GPT heads")
    add("--gpt_embd", type=int, default=512, help="GPT embedding size")
    add("--observables", type=_list, default=[],
        help="Observables to use (default all).")
    add("--lr_decay", action=argparse.BooleanOptionalAction, default=False,
        help="Decay learning rate.")
    add("--warmup_tokens", type=int, default=512 * 20, help="Warmup tokens.")
    add("--final_tokens", type=int, default=10 * 200000,
        help="Decay horizon tokens.")
    add("--model", default="gpt", choices=("gpt", "ffnet"),
        help="Choices: gpt/ffnet")
    add("--num_workers", type=int, default=0,
        help="Native prefetch threads (0 = in-process numpy batches).")
    add("--device", default="cuda", help="Where the model trains.")
    return parser.parse_args(argv)


def build(args):
    """The trainer of parsed arguments: the datasets, the model (its
    config written to ``--config_path``) and the ``Trainer``."""
    from dm_control_torch.scripts.dataset import TrajectoryDataset
    from dm_control_torch.scripts.model import (FFConfig, FFNet, GPT,
                                                GPTConfig)
    from dm_control_torch.scripts.trainer import Trainer, TrainerConfig

    block = args.block_size if args.model == "gpt" else 1
    train_ds = TrajectoryDataset(args.dataset, block,
                                 args.observables or None)
    test_ds = None
    if args.test_dataset:
        test_ds = TrajectoryDataset(args.test_dataset, block,
                                    args.observables or None)
    if args.model == "gpt":
        config = GPTConfig(train_ds.observation_size, train_ds.action_size,
                           block, n_layer=args.gpt_layers,
                           n_head=args.gpt_heads, n_embd=args.gpt_embd)
        model = GPT(config)
    else:
        config = FFConfig(train_ds.observation_size, train_ds.action_size)
        model = FFNet(config)
    config.to_json(args.config_path)
    tconf = TrainerConfig(
        max_epochs=args.max_epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        grad_norm_clip=args.grad_norm_clip, lr_decay=args.lr_decay,
        warmup_tokens=args.warmup_tokens, final_tokens=args.final_tokens,
        ckpt_path=args.checkpoint_path, num_workers=args.num_workers)
    return Trainer(model, train_ds, test_ds, tconf, device=args.device)


def main(argv=None):
    """Trains (reference train.py:31-95); returns the loss history."""
    args = parse_args(argv)
    for name, value in sorted(vars(args).items()):
        print(f"{name}: {value}")
    trainer = build(args)
    history = trainer.train()
    print(f"best loss: {trainer.best_loss:f}")
    return history


if __name__ == "__main__":
    main()
