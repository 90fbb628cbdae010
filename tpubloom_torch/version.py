"""Version constant: the reference's (``tpubloom/version.py``), so that
both packages of one release report the same version."""

__version__ = "0.1.0"
