"""Configurations: the index's knobs (``bwt_index``) and the LM harness's
ten architectures (``base.ArchConfig``, one ``configs/<id>.py`` each)."""
