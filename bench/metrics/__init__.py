"""The readers of the metrics, one file a metric name (``metrics/<name>.py``),
and ``_work.py``, the operations and bytes they count from shapes."""
