"""The paper's models (``small``)."""
