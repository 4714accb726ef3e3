"""Serving: the artifact writer and modules reader (`export.py`), the
program reader that builds no model (`program.py`) and the HTTP service
(`server.py`). Nothing is imported here, so reading programs does not
import the model code."""
