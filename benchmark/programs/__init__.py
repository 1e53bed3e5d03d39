"""The port as the benchmark drives it (``programs/rows.py``: the rows
layout).  These are the only modules of the benchmark that import the
port."""
