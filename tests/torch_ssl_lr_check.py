"""Fine-tuning at the reference's learning rate, JAX package against the
port, on the CPU (not collected by pytest: a check run by hand).

    JAX_PLATFORMS=cpu python tests/torch_ssl_lr_check.py

Both ``train_ssl``s start from the same 61 KB JAX export
(``results/simclr_bs16_nepoch8_cifar10_temp05.msgpack``: stage sizes
(1, 1, 1, 1), width 2) and fine-tune with the defaults the card's run used
(lr 0.02, Nesterov momentum 0.98, batch 64, 10% of the labels by weighted
draws: 5 steps an epoch) for 2 epochs on the split ``chip_smoke.py``'s
ssl phase uses: 4,096 synthetic CIFAR-shaped images (seed 0), 80/20, the
819 as the test set. Prints each side's per-epoch training loss and
accuracy and its test accuracy, and whether each failed to learn (a
training loss not finite, or above ln 10 = 2.303, chance for 10 classes,
after the first epoch). Draws differ between the frameworks (JAX keys,
PyTorch generators), so the two runs see other batches of the same
data.
"""

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

EXPORT = os.path.join(ROOT,
                      "results/simclr_bs16_nepoch8_cifar10_temp05.msgpack")


def _model_fields():
    with open(EXPORT + ".json") as f:
        m = json.load(f)["model"]
    m["stage_sizes"] = tuple(m["stage_sizes"])
    return m


def _data():
    from simclr_tpu_torch.data.datasets import synthetic_dataset
    from simclr_tpu_torch.data.pipeline import split_indices

    images, labels = synthetic_dataset(4096, img_size=32, seed=0)
    tr, te = split_indices(4096, 0.2)
    return images[tr], labels[tr], images[te], labels[te]


def run_jax(data):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from simclr_tpu import config as jcfg
    from simclr_tpu.data.pipeline import DeviceDataset
    from simclr_tpu.train.ssl import train_ssl

    cfg = jcfg.Config(model=jcfg.ModelConfig(**_model_fields()))
    x, y, xt, yt = data
    res = train_ssl(cfg, DeviceDataset.from_numpy(x, y),
                    test_ds=DeviceDataset.from_numpy(xt, yt),
                    pretrained_path=EXPORT, n_epochs=2, log=lambda _: None)
    return res.history.to_dict(), res.test_acc


def run_port(data):
    from simclr_tpu_torch import config as tcfg
    from simclr_tpu_torch.data.pipeline import DeviceDataset
    from simclr_tpu_torch.train.ssl import train_ssl

    cfg = tcfg.Config(model=tcfg.ModelConfig(**_model_fields()))
    x, y, xt, yt = data
    res = train_ssl(cfg, DeviceDataset.from_numpy(x, y, "cpu"),
                    test_ds=DeviceDataset.from_numpy(xt, yt, "cpu"),
                    pretrained_path=EXPORT, n_epochs=2, log=lambda _: None)
    return res.history.to_dict(), res.test_acc


def failed_to_learn(hist) -> bool:
    losses = hist["loss"]["train"]
    return (not all(math.isfinite(v) for v in losses)
            or any(v > math.log(10) for v in losses[1:]))


if __name__ == "__main__":
    data = _data()
    for name, fn in (("jax", run_jax), ("port", run_port)):
        hist, test_acc = fn(data)
        print(f"{name}: train loss {hist['loss']['train']}, train acc "
              f"{hist['accuracy']['train']}, test acc {test_acc}, "
              f"failed to learn {failed_to_learn(hist)}", flush=True)
