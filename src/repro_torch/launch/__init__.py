"""Launch layer: the device mesh (``mesh``) and the serving drivers
(``serve`` for the LMs, ``serve_mmo`` for semiring problems).

Counterpart of ``repro.launch``.  The dry run, training and elasticity
drivers and the production mesh come with ROADMAP Queue 1 item 13.
"""
