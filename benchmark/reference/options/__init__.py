"""The reference's model options, one module an option (see ``stepper.py``)."""
