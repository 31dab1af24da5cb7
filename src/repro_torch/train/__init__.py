"""Training state and step builders of the port (counterpart of
``repro/train``), for one device."""
