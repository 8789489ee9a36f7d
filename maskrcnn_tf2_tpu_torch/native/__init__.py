"""Native (C) host code, built with the system C compiler at first use."""
