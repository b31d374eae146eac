"""Host-side helpers. Kept import-light: nothing here pulls a GPU runtime or
a plotting library at import time."""
