"""Launch layer: the device mesh and the production layout (``mesh``), the
serving entry points (``serve`` for the LMs, ``serve_mmo`` for semiring
problems), training (``train``, one device), the dry run of
every (architecture × shape × mesh) cell and of the pod-scale APSP
squaring (``dryrun``, ``dryrun_apsp``, with ``specs``), and the elastic
control plane (``elastic``).

Counterpart of ``repro.launch``.  Training on a mesh comes with ROADMAP
Queue 1 item 13, step 6.2.
"""
