"""Launch layer: the device mesh and the production layout (``mesh``), the
serving entry points (``serve`` for the LMs, ``serve_mmo`` for semiring
problems), training (``train``, on one device or tensor-parallel on a mesh
with ``--shards``), the dry run of every (architecture × shape × mesh)
cell and of the pod-scale APSP squaring (``dryrun``, ``dryrun_apsp``, with
``specs``), and the elastic control plane (``elastic``).

Counterpart of ``repro.launch``.
"""
