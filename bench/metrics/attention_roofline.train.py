"""attention_roofline.train: the attention kernels' share of their
roofline in the training step: the bounds of every forward call
(``flash_attention``, the remat's recomputation included) and backward
call (``flash_attention_bwd``), counted from their shapes, over the
device time in those calls' ranges, in %. Device trace."""
from bench.metrics._work import attention_bwd, attention_fwd, driver_is, \
    roofline

SPANS = {
    "flash_attention": [
        "repro_torch.kernels.flash_attention.flash_attention:flash_attention",
        "repro_torch.models.layers:flash_attention"],
    "flash_attention_bwd": [
        "repro_torch.kernels.flash_attention.flash_attention_bwd:"
        "flash_attention_bwd"]}


def read(run):
    if not driver_is(run, "train"):
        return None
    return roofline(run, [("flash_attention", attention_fwd),
                          ("flash_attention_bwd", attention_bwd)])
