"""optimizer_share.train: the device time of AdamW (``adamw_update``,
as ``train/train_step.py`` calls it) over the step's, in %. Device
trace."""
from bench.metrics._work import driver_is, share

SPANS = {"adamw_update": ["repro_torch.train.train_step:adamw_update"]}


def read(run):
    return share(run, "adamw_update", "step") if driver_is(run, "train") \
        else None
