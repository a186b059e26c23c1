"""The loops that serve a traffic mix, one file a ``driver`` name."""
