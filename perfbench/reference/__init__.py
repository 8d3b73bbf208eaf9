"""The plain float32 reference that decides `correct`; imports nothing of the port."""
