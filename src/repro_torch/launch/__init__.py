"""Entry points and their machinery (the counterparts of
``repro.launch``): ``serve``, ``train``, ``pipeline`` and ``fleet`` (the
CLIs), ``mesh`` (the production, elastic and host meshes,
``repro/launch/mesh.py``), ``dryrun`` (every cell traced on ``meta``,
``repro/launch/dryrun.py``) and ``op_analysis`` (its op counter, the
counterpart of ``repro/launch/hlo_analysis.py``)."""
