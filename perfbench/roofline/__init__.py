"""The yardstick's peaks and each kernel's operations and bytes from its shapes."""
