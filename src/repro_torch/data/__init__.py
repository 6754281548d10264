"""The training data: the synthetic LM stream (``pipeline.py``)."""
