from .server import Replica, Request, SessionRouter, session_key

__all__ = ["Replica", "Request", "SessionRouter", "session_key"]
