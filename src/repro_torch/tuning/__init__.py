"""Shape buckets shared by the serving engine (``cost_table.bucket_dim``,
``bucket_shape``).

The reference's measured cost table, autotuner and ``backend="auto"``
dispatch are not ported yet (ROADMAP Queue 1 item 7), so none of its
public names is exported here.
"""

__all__: list = []
