"""Server plane of the port: the websocket data server and its entry point."""

import os


def bundled_web_root():
    """Absolute path of the bundled web client (the repo's ``web/``), or
    None when it is not shipped (e.g. a bare wheel install)."""
    root = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "web")
    return root if os.path.isdir(root) else None
