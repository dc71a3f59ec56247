"""Test-support utilities shipped with the library (deterministic fault
injection for crash-recovery testing; see
``repro_torch.testing.faultinject``)."""
