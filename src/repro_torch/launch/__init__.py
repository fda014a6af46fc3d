"""Launch layer: the device mesh (``mesh``), the serving drivers (``serve``
for the LMs, ``serve_mmo`` for semiring problems) and the training driver
(``train``, one device).

Counterpart of ``repro.launch``.  The dry run, the elasticity driver, the
production mesh and the LM's sharding come with ROADMAP Queue 1 item 13
(steps 5 and 6).
"""
