"""attention_roofline.prefill: the attention kernel's share of its
roofline in prefill: the bounds of its calls (``flash_attention``),
counted from their shapes, over the device time in its range, in %.
Device trace."""
from bench.metrics._work import attention_fwd, driver_is, roofline

SPANS = {"flash_attention": ["repro_torch.models.layers:flash_attention"]}


def read(run):
    if not driver_is(run, "prefill"):
        return None
    return roofline(run, [("flash_attention", attention_fwd)])
