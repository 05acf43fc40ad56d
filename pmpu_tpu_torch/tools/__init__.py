"""Tools of the port: measurement tools that run on the card, the parity
demonstrator against the reference mirror, the stream-training soak, and
the offline NIfTI data tools (no device)."""
